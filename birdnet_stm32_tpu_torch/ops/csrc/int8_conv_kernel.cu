// The INT8 executor's integer convolutions for Hopper (sm_90a): int8 NHWC
// codes in, int32 accumulators in registers, the TFLite requantization in
// the epilogue, int8 codes out.
//
// These replace no Pallas kernel: the JAX package leaves the executor's
// convolutions to XLA (birdnet_stm32_tpu/quant/tflite_import.py), and the
// port ran them as plain PyTorch (quant/tflite_import.py::_tap_conv, the
// float32 / float64 GEMM of int8 codes, `_requant_fn` / `_mbqm_fn` on
// int64 tensors, `_op_add_sub`), which crosses device memory as int32 and
// int64 some 10-20 times per activation and launches ~30 elementwise
// kernels per convolution. Two kernels:
//
// int8_conv_taps_kernel: DEPTHWISE_CONV_2D with any kh x kw, stride,
// dilation and depth multiplier, and CONV_2D over one input channel (the
// same class: every output channel reads input channel c / multiplier).
// A thread owns CV consecutive output channels of one output pixel;
// neighbouring threads take neighbouring channel groups, then pixels, so
// loads and stores are coalesced along the channels (16-byte vectors where
// the channels allow). The input is read through the element strides it
// is given (a TRANSPOSE the executor elided, or a view), so no copy is
// made; SAME padding is TF's asymmetric split, decided per tap by an index
// test that substitutes the input zero point, so no padded copy is made.
//
// int8_conv_pointwise_kernel: 1x1 CONV_2D with any stride, [rows, C_in] x
// [C_in, C_out] with C_in <= 256. A block keeps a [C_in, 64] slice of the
// weights in shared memory as packed int8 words; a thread computes 2 rows
// x 8 output channels with __dp4a. Its epilogue can also take the
// residual of the ADD that follows the convolution and apply that ADD
// exactly (both rescales at left_shift 20, the output multiplier, + zp,
// the clamp), so the ADD's output is the kernel's output; on request it
// also stores the convolution's own codes.
//
// The epilogue is `_mbqm_fn`'s arithmetic in 64-bit integers:
// ((acc + correction) << left) * qm + K) >> (31 + right), + zp, clamp to
// the fused activation's bounds, K = 2^30 + (right > 0 ? 2^(30 + right) :
// 0), the multiply and add wrapping as int64 tensors do. With
// requant="fast" (FAST) it is `_requant_fn`'s round_half_away(float32(acc
// + correction) * float32(m)) + zp, each operation written out so nvcc
// contracts nothing. The correction (bias - zi * sum w, plus a folded
// constant concat's term) and the multipliers are uploaded once per
// executor. Every step is exact integer arithmetic (int32 sums wrap as
// the plain path's int32 taps do, in any order; a 1x1 conv's 256 products
// stay far below 2^31), so the codes equal the plain path's bit for bit.
//
// What bounds them: the bytes. At the flagship's body (B = 64) the int8
// activations come to ~60 MB read plus written per batch, ~20 us at 3.35
// TB/s; its 1.75 G MACs take ~13 us on __dp4a. The design's answer is one
// int8 read of each input and one int8 write of each output: no int32 or
// int64 tensor reaches device memory, and the residual ADD costs one more
// int8 read instead of a launch and five int64 passes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 65535;
// The pointwise kernel's tile: 8 output channels and 2 rows a thread, at
// most 64 channels and 256 input channels (64 words) a block.
constexpr int PW_CV = 8;
constexpr int PW_ROWS = 2;
constexpr int PW_MAX_TN = 64;
constexpr int PW_MAX_K = 256;

// How the taps kernel reads a pixel's input channels.
enum TapsRead { READ_VECTOR = 0, READ_ONE = 1, READ_GATHER = 2 };

struct Requant {
  const long long* correction;  // [C_out]
  const int* qm;                // [C_out] fixed-point multipliers (exact)
  const int* shift;             // [C_out]
  const float* mult;            // [C_out] float32 multipliers (fast)
  int zp, lo, hi;
};

// TFLite int8 ADD after the convolution (`_op_add_sub`): each input
// rescaled to twice the larger input scale at 20 fractional bits, summed,
// requantized to the output.
struct AddEpilogue {
  int z_res, qm_res, shift_res;
  int z_conv, qm_conv, shift_conv;
  int qm_out, shift_out, zp, lo, hi;
};

struct Taps {
  const int8_t* x;
  long long xb, xh, xw, xc;  // element strides of the input
  const int8_t* w;           // [taps, channels]: tap (p, q) at row p * tap_h + q * tap_w
  int tap_h, tap_w;
  int8_t* out;
  long long ob, oh, ow;      // element strides of the output; channels contiguous
  int height, width, out_h, out_w, channels;
  int kh, kw, sh, sw, dh, dw, pad_top, pad_left, repeat, zi;
  long long pixels;          // batch * out_h * out_w
  Requant rq;
};

struct Pointwise {
  const int8_t* x;
  long long xb, xh, xw;      // element strides of an output row's input pixel (conv strides folded in)
  const int* w;              // [k_words, npad]: word (k, n) holds weights n, 4k .. 4k + 3
  int k_words, npad, tn;
  int8_t* out;               // [rows, channels]
  int8_t* conv_out;          // [rows, channels] or null
  const int8_t* res;         // [rows, channels] or null (ADD)
  int out_h, out_w, in_channels, channels;
  long long rows;
  Requant rq;
  AddEpilogue add;
};

template <int N> struct Codes;
template <> struct Codes<16> { using raw = int4; };
template <> struct Codes<8> { using raw = int2; };
template <> struct Codes<4> { using raw = int; };
template <> struct Codes<1> { using raw = signed char; };

template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, int (&v)[N]) {
  union { typename Codes<N>::raw raw; int8_t b[N]; } u;
  u.raw = __ldg(reinterpret_cast<const typename Codes<N>::raw*>(p));
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = u.b[j];
}

template <int N>
__device__ __forceinline__ void store_codes(int8_t* p, const int (&v)[N]) {
  union { typename Codes<N>::raw raw; int8_t b[N]; } u;
#pragma unroll
  for (int j = 0; j < N; ++j) u.b[j] = static_cast<int8_t>(v[j]);
  *reinterpret_cast<typename Codes<N>::raw*>(p) = u.raw;
}

// MultiplyByQuantizedMultiplier as `_mbqm_fn` computes it on int64
// tensors: the shift and product wrap as two's complement, the right
// shift is arithmetic.
__device__ __forceinline__ long long mbqm(long long x, int qm, int shift) {
  const int left = shift > 0 ? shift : 0;
  const int right = shift > 0 ? 0 : -shift;
  const unsigned long long k = (1ull << 30) + (right > 0 ? (1ull << (30 + right)) : 0ull);
  const unsigned long long p =
      (static_cast<unsigned long long>(x) << left) * static_cast<unsigned long long>(qm) + k;
  return static_cast<long long>(p) >> (31 + right);
}

__device__ __forceinline__ int clamp_code(long long q, int lo, int hi) {
  return static_cast<int>(q < lo ? lo : (q > hi ? hi : q));
}

template <bool FAST>
__device__ __forceinline__ int requant(int acc, long long correction, int qm, int shift,
                                       float mult, const Requant& r) {
  const long long x = static_cast<long long>(acc) + correction;
  long long q;
  if (FAST) {
    // sign(f) * floor(|f| + 0.5), as _round_away on float32.
    const float f = __fmul_rn(__ll2float_rn(x), mult);
    const float a = floorf(__fadd_rn(fabsf(f), 0.5f));
    q = static_cast<int>(f > 0.0f ? a : (f < 0.0f ? -a : 0.0f));
  } else {
    q = mbqm(x, qm, shift);
  }
  return clamp_code(q + r.zp, r.lo, r.hi);
}

__device__ __forceinline__ int fused_add(int conv, int res, const AddEpilogue& p) {
  const long long a = mbqm(static_cast<long long>(res - p.z_res) * (1ll << 20), p.qm_res,
                           p.shift_res);
  const long long b = mbqm(static_cast<long long>(conv - p.z_conv) * (1ll << 20), p.qm_conv,
                           p.shift_conv);
  return clamp_code(mbqm(a + b, p.qm_out, p.shift_out) + p.zp, p.lo, p.hi);
}

template <int CV, int READ, bool FAST>
__global__ void __launch_bounds__(THREADS) int8_conv_taps_kernel(const Taps a) {
  const int groups = a.channels / CV;
  const long long items = a.pixels * groups;
  for (long long it = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; it < items;
       it += static_cast<long long>(gridDim.x) * THREADS) {
    const int c0 = static_cast<int>(it % groups) * CV;
    long long pix = it / groups;
    const int ow = static_cast<int>(pix % a.out_w);
    pix /= a.out_w;
    const int oh = static_cast<int>(pix % a.out_h);
    const long long b = pix / a.out_h;
    const int8_t* xb = a.x + b * a.xb;
    int acc[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[j] = 0;
    for (int p = 0; p < a.kh; ++p) {
      const int ih = oh * a.sh - a.pad_top + p * a.dh;
      const bool row_ok = ih >= 0 && ih < a.height;
      for (int q = 0; q < a.kw; ++q) {
        const int iw = ow * a.sw - a.pad_left + q * a.dw;
        const bool ok = row_ok && iw >= 0 && iw < a.width;
        const int8_t* px = xb + ih * a.xh + iw * a.xw;  // read only when ok
        int xv[CV], wv[CV];
        if (READ == READ_VECTOR) {
          if (ok) {
            load_codes<CV>(px + c0, xv);
          } else {
#pragma unroll
            for (int j = 0; j < CV; ++j) xv[j] = a.zi;
          }
        } else if (READ == READ_ONE) {
          const int v = ok ? static_cast<int>(__ldg(px)) : a.zi;
#pragma unroll
          for (int j = 0; j < CV; ++j) xv[j] = v;
        } else {
#pragma unroll
          for (int j = 0; j < CV; ++j)
            xv[j] = ok ? static_cast<int>(__ldg(px + ((c0 + j) / a.repeat) * a.xc)) : a.zi;
        }
        load_codes<CV>(a.w + static_cast<long long>(p * a.tap_h + q * a.tap_w) * a.channels + c0,
                       wv);
#pragma unroll
        for (int j = 0; j < CV; ++j) acc[j] += xv[j] * wv[j];
      }
    }
    int code[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = c0 + j;
      code[j] = requant<FAST>(acc[j], __ldg(a.rq.correction + c), FAST ? 0 : __ldg(a.rq.qm + c),
                              FAST ? 0 : __ldg(a.rq.shift + c), FAST ? __ldg(a.rq.mult + c) : 0.0f,
                              a.rq);
    }
    store_codes<CV>(a.out + b * a.ob + oh * a.oh + ow * a.ow + c0, code);
  }
}

// 16 input bytes of a row from byte k as four words, zero past n.
template <int VEC>
__device__ __forceinline__ void load_k16(const int8_t* p, int k, int n, int (&x)[4]) {
  if (VEC == 16) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + k));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if (VEC == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = k + 4 * i < n ? __ldg(reinterpret_cast<const int*>(p + k + 4 * i)) : 0;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned u = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + 4 * i + j;
        if (kk < n) u |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + kk))) << (8 * j);
      }
      x[i] = static_cast<int>(u);
    }
  }
}

template <int VEC, bool FAST, bool ADD>
__global__ void __launch_bounds__(THREADS) int8_conv_pointwise_kernel(const Pointwise a) {
  __shared__ __align__(16) int ws[PW_MAX_K / 4 * PW_MAX_TN];
  const int tn = a.tn;
  const int groups = tn / PW_CV;
  const int row_threads = THREADS / groups;
  const int n0 = blockIdx.y * tn;
  for (int i = threadIdx.x; i < a.k_words * tn; i += THREADS)
    ws[i] = __ldg(a.w + static_cast<long long>(i / tn) * a.npad + n0 + i % tn);
  __syncthreads();

  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int c0 = n0 + g * PW_CV;
  long long corr[PW_CV];
  int qm[PW_CV], sh[PW_CV];
  float mu[PW_CV];
#pragma unroll
  for (int j = 0; j < PW_CV; ++j) {
    const int c = min(c0 + j, a.channels - 1);  // columns past C_out are never stored
    corr[j] = __ldg(a.rq.correction + c);
    qm[j] = FAST ? 0 : __ldg(a.rq.qm + c);
    sh[j] = FAST ? 0 : __ldg(a.rq.shift + c);
    mu[j] = FAST ? __ldg(a.rq.mult + c) : 0.0f;
  }
  const bool full = (a.channels % PW_CV) == 0;  // 8-byte stores and residual loads
  const long long tile = static_cast<long long>(row_threads) * PW_ROWS;
  for (long long m0 = static_cast<long long>(blockIdx.x) * tile; m0 < a.rows;
       m0 += static_cast<long long>(gridDim.x) * tile) {
    long long m[PW_ROWS];
    const int8_t* px[PW_ROWS];
#pragma unroll
    for (int i = 0; i < PW_ROWS; ++i) {
      m[i] = m0 + r + static_cast<long long>(i) * row_threads;
      px[i] = a.x;
      if (m[i] < a.rows) {
        long long t = m[i];
        const int ow = static_cast<int>(t % a.out_w);
        t /= a.out_w;
        const int oh = static_cast<int>(t % a.out_h);
        px[i] = a.x + (t / a.out_h) * a.xb + oh * a.xh + ow * a.xw;
      }
    }
    int acc[PW_ROWS][PW_CV];
#pragma unroll
    for (int i = 0; i < PW_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < PW_CV; ++j) acc[i][j] = 0;
    for (int k4 = 0; k4 < a.k_words; k4 += 4) {
      int xv[PW_ROWS][4];
#pragma unroll
      for (int i = 0; i < PW_ROWS; ++i) {
        if (m[i] < a.rows) {
          load_k16<VEC>(px[i], 4 * k4, a.in_channels, xv[i]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) xv[i][kk] = 0;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int4 w0 = *reinterpret_cast<const int4*>(&ws[(k4 + kk) * tn + g * PW_CV]);
        const int4 w1 = *reinterpret_cast<const int4*>(&ws[(k4 + kk) * tn + g * PW_CV + 4]);
        const int wv[PW_CV] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < PW_ROWS; ++i)
#pragma unroll
          for (int j = 0; j < PW_CV; ++j) acc[i][j] = __dp4a(xv[i][kk], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PW_ROWS; ++i) {
      if (m[i] >= a.rows || c0 >= a.channels) continue;
      const long long at = m[i] * a.channels + c0;
      int code[PW_CV], res[PW_CV];
#pragma unroll
      for (int j = 0; j < PW_CV; ++j)
        code[j] = requant<FAST>(acc[i][j], corr[j], qm[j], sh[j], mu[j], a.rq);
      if (full) {
        if (a.conv_out != nullptr) store_codes<PW_CV>(a.conv_out + at, code);
        if (ADD) {
          load_codes<PW_CV>(a.res + at, res);
#pragma unroll
          for (int j = 0; j < PW_CV; ++j) code[j] = fused_add(code[j], res[j], a.add);
        }
        store_codes<PW_CV>(a.out + at, code);
      } else {
#pragma unroll
        for (int j = 0; j < PW_CV; ++j) {
          if (c0 + j >= a.channels) continue;
          if (a.conv_out != nullptr) a.conv_out[at + j] = static_cast<int8_t>(code[j]);
          const int v = ADD ? fused_add(code[j], a.res[at + j], a.add) : code[j];
          a.out[at + j] = static_cast<int8_t>(v);
        }
      }
    }
  }
}

template <int CV, int READ>
void launch_taps(const Taps& a, bool fast, int blocks, cudaStream_t s) {
  if (fast) {
    int8_conv_taps_kernel<CV, READ, true><<<blocks, THREADS, 0, s>>>(a);
  } else {
    int8_conv_taps_kernel<CV, READ, false><<<blocks, THREADS, 0, s>>>(a);
  }
}

template <int CV>
int launch_taps_read(const Taps& a, int read, bool fast, int blocks, cudaStream_t s) {
  switch (read) {
    case READ_VECTOR: launch_taps<CV, READ_VECTOR>(a, fast, blocks, s); return 0;
    case READ_ONE: launch_taps<CV, READ_ONE>(a, fast, blocks, s); return 0;
    case READ_GATHER: launch_taps<CV, READ_GATHER>(a, fast, blocks, s); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC>
void launch_pointwise(const Pointwise& a, bool fast, bool add, dim3 grid, cudaStream_t s) {
  if (fast && add) {
    int8_conv_pointwise_kernel<VEC, true, true><<<grid, THREADS, 0, s>>>(a);
  } else if (fast) {
    int8_conv_pointwise_kernel<VEC, true, false><<<grid, THREADS, 0, s>>>(a);
  } else if (add) {
    int8_conv_pointwise_kernel<VEC, false, true><<<grid, THREADS, 0, s>>>(a);
  } else {
    int8_conv_pointwise_kernel<VEC, false, false><<<grid, THREADS, 0, s>>>(a);
  }
}

Requant make_requant(const void* correction, const void* qm, const void* shift, const void* mult,
                     const int* bounds) {
  return Requant{static_cast<const long long*>(correction), static_cast<const int*>(qm),
                 static_cast<const int*>(shift), static_cast<const float*>(mult), bounds[0],
                 bounds[1], bounds[2]};
}

extern "C" {

// The taps kernel on `stream`; returns cudaGetLastError() after the launch.
// x_strides: batch, height, width, channel (elements); out_strides: batch,
// height, width; dims: batch, height, width, out_h, out_w, channels; conv:
// kh, kw, sh, sw, dh, dw, pad_top, pad_left, repeat, zi, tap_h, tap_w;
// bounds: zp, lo, hi. `cv` output channels a thread (16, 8, 4 or 1,
// dividing channels), `read` a TapsRead.
int int8_conv_taps(const void* x, const long long* x_strides, const void* w, void* out,
                   const long long* out_strides, const int* dims, const int* conv,
                   const void* correction, const void* qm, const void* shift, const void* mult,
                   const int* bounds, int cv, int read, int fast, void* stream) {
  Taps a;
  a.x = static_cast<const int8_t*>(x);
  a.xb = x_strides[0]; a.xh = x_strides[1]; a.xw = x_strides[2]; a.xc = x_strides[3];
  a.w = static_cast<const int8_t*>(w);
  a.out = static_cast<int8_t*>(out);
  a.ob = out_strides[0]; a.oh = out_strides[1]; a.ow = out_strides[2];
  a.height = dims[1]; a.width = dims[2]; a.out_h = dims[3]; a.out_w = dims[4];
  a.channels = dims[5];
  a.kh = conv[0]; a.kw = conv[1]; a.sh = conv[2]; a.sw = conv[3]; a.dh = conv[4]; a.dw = conv[5];
  a.pad_top = conv[6]; a.pad_left = conv[7]; a.repeat = conv[8]; a.zi = conv[9];
  a.tap_h = conv[10]; a.tap_w = conv[11];
  a.pixels = static_cast<long long>(dims[0]) * a.out_h * a.out_w;
  a.rq = make_requant(correction, qm, shift, mult, bounds);
  const long long items = a.pixels * (a.channels / cv);
  if (items == 0) return 0;
  const int blocks = static_cast<int>(std::min((items + THREADS - 1) / THREADS, MAX_BLOCKS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (cv) {
    case 16: rc = launch_taps_read<16>(a, read, fast != 0, blocks, s); break;
    case 8: rc = launch_taps_read<8>(a, read, fast != 0, blocks, s); break;
    case 4: rc = launch_taps_read<4>(a, read, fast != 0, blocks, s); break;
    case 1: rc = launch_taps_read<1>(a, read, fast != 0, blocks, s); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// The pointwise kernel on `stream`; returns cudaGetLastError() after the
// launch. x_strides: an output row's input pixel per batch, height, width
// (elements, the conv strides folded in); weights: k_words, npad, tn;
// dims: batch, out_h, out_w, in_channels, channels; bounds: zp, lo, hi;
// add: the AddEpilogue's 11 fields in order, or null without the ADD
// (then `res` is null too); `vec` the input load width (16, 4 or 1).
int int8_conv_pointwise(const void* x, const long long* x_strides, const void* w,
                        const int* weights, void* out, void* conv_out, const void* res,
                        const int* dims, const void* correction, const void* qm,
                        const void* shift, const void* mult, const int* bounds, const int* add,
                        int vec, int fast, void* stream) {
  Pointwise a;
  a.x = static_cast<const int8_t*>(x);
  a.xb = x_strides[0]; a.xh = x_strides[1]; a.xw = x_strides[2];
  a.w = static_cast<const int*>(w);
  a.k_words = weights[0]; a.npad = weights[1]; a.tn = weights[2];
  a.out = static_cast<int8_t*>(out);
  a.conv_out = static_cast<int8_t*>(conv_out);
  a.res = static_cast<const int8_t*>(res);
  a.out_h = dims[1]; a.out_w = dims[2]; a.in_channels = dims[3]; a.channels = dims[4];
  a.rows = static_cast<long long>(dims[0]) * a.out_h * a.out_w;
  a.rq = make_requant(correction, qm, shift, mult, bounds);
  a.add = add == nullptr ? AddEpilogue{} : AddEpilogue{add[0], add[1], add[2], add[3], add[4],
                                                       add[5], add[6], add[7], add[8], add[9],
                                                       add[10]};
  if (a.tn % PW_CV != 0 || a.tn > PW_MAX_TN || THREADS % (a.tn / PW_CV) != 0 ||
      a.k_words * 4 > PW_MAX_K || a.k_words % 4 != 0 || a.npad % a.tn != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.rows == 0) return 0;
  const long long tile = static_cast<long long>(THREADS / (a.tn / PW_CV)) * PW_ROWS;
  const dim3 grid(static_cast<unsigned>(std::min((a.rows + tile - 1) / tile, MAX_BLOCKS)),
                  static_cast<unsigned>(a.npad / a.tn));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_add = add != nullptr;
  switch (vec) {
    case 16: launch_pointwise<16>(a, fast != 0, with_add, grid, s); break;
    case 4: launch_pointwise<4>(a, fast != 0, with_add, grid, s); break;
    case 1: launch_pointwise<1>(a, fast != 0, with_add, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
