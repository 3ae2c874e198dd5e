// A noisy layer's noisy weight and bias in one launch: the layer's noise key
// from the network's key, the factorised noise f(e_in), f(e_out) and
// w = mu + sigma * f(e_in) f(e_out)^T, b = mu_b + sigma_b * f(e_out).
//
// Replaces no Pallas kernel. The JAX package draws the noise with
// jax.random inside flax's NoisyDense (gym_simpletetris_tpu/models/dqn.py),
// which XLA fuses. The port's plain version (models/dqn.py
// NoisyDense.noisy_weights over core/threefry.py flax_rng, split, normal
// and sqrt_f32, the oracle this kernel is held to) runs threefry2x32 as
// int64 tensor ops and the float32 erf_inv with its fused multiply-adds as
// float64 round trips: about 1,650 launches a layer, three layers a
// forward, so the host's dispatch of them was most of a Rainbow trainer
// call and the card sat idle under it. This kernel makes a layer one
// launch.
//
// What it computes, bit for bit as the plain version:
// - the layer key: fold_in(key, fold) = threefry2x32(key, (0, fold)), fold
//   the first 4 bytes of the SHA-1 of the layer's flax path and rng counter
//   (threefry.flax_fold, computed once per layer on the host);
// - ki, ko = split(layer key): threefry2x32(layer key, (0, 0)), (0, 1);
// - e_in[j] = f(normal(ki)[j]) for j < in_f and e_out[o] = f(normal(ko)[o])
//   for o < features, f(e) = sign(e) sqrt(|e|). normal(k)[i] takes
//   bits = y0 ^ y1 of threefry2x32(k, (0, i)), uniform's mantissa trick
//   (23 bits under the exponent of 1.0, minus 1, times hi - lo = 2, plus
//   lo, max with lo), then sqrt(2) * erf_inv(u) as XLA's CPU backend
//   computes it (Giles' polynomial over log1p, log and sqrt, each
//   multiply-add rounded once to float32 from a float64 product and sum);
// - w[r, j] = float(double(w_sigma[r, j]) * double(e_in[j] * e_out[at + r])
//   + double(w_mu[r, j])) for the rows [at, at + rows) of the layer (a
//   model-axis rank's block, or all of them), the outer product one float32
//   multiply; b[o] = float(double(b_sigma[o]) * double(e_out[o]) +
//   double(b_mu[o])) for every o < features (every rank holds the whole
//   bias);
// - e_in and e_out themselves, which the backward reads.
// Every float32 and float64 multiply, add, subtract and divide is written
// as its _rn intrinsic: nvcc contracts a * b + c into one fused
// multiply-add by default, whose single rounding differs now and then from
// the plain version's two. A "fused" multiply-add of the plain version is a
// float64 product (exact for float32 operands) and a float64 sum, rounded
// to float32: not fmaf, whose one rounding differs from that double
// rounding now and then.
//
// What bounds it on the H100: the bytes. A 3136 x 512 layer reads mu and
// sigma and writes w, 19.3 MB, about 5.8 us at 3.35 TB/s; the draws are
// ~0.1 us of threefry and float64 arithmetic a thread. A block takes 256
// columns by 32 rows of the layer's features: each thread draws e_in of
// its column, the first warp draws e_out of the block's rows into shared
// memory, then each thread writes its column of the 32 rows (neighbouring
// threads on neighbouring words). e_in is drawn once per row tile and
// e_out once per column tile, so a draw is redone features / 32 or
// in_f / 256 times: a second launch to draw each once would cost more.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;   // columns of a block
constexpr int kRows = 32;       // features of a block

// threefry.py _fma: a * b + c in float64 (the product exact), rounded to
// float32.
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(double(a), double(b)), double(c)));
}

// threefry.py sqrt_f32: the float64 root, rounded.
__device__ __forceinline__ float sqrt_f32(float x) {
  return __double2float_rn(__dsqrt_rn(double(x)));
}

// The plain version's constants are Python floats rounded to float32 by
// torch: a double literal cast to float is that rounding (a float literal
// would round the decimal once, which differs now and then).
#define F32(c) static_cast<float>(c)

// threefry.py log_f32: the Cephes log (Eigen's plog), for positive normal x.
__device__ float log_f32(float x) {
  const int32_t bits = __float_as_int(x);
  float e = __fsub_rn(__int2float_rn((bits >> 23) & 0xFF), 126.0f);
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool small = m < F32(0.707106781186547524);
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = fma_f32(fma_f32(F32(7.0376836292E-2), m, F32(-1.1514610310E-1)),
                    m, F32(1.1676998740E-1));
  const float y1 =
      fma_f32(fma_f32(F32(-1.2420140846E-1), m, F32(1.4249322787E-1)), m,
              F32(-1.6668057665E-1));
  const float y2 =
      fma_f32(fma_f32(F32(2.0000714765E-1), m, F32(-2.4999993993E-1)), m,
              F32(3.3333331174E-1));
  y = fma_f32(fma_f32(y, x3, y1), x3, y2);
  y = fma_f32(y, x3, __fmul_rn(e, F32(-2.12194440e-4)));
  return __fadd_rn(__fadd_rn(__fsub_rn(m, __fmul_rn(x2, 0.5f)), y),
                   __fmul_rn(e, 0.693359375f));
}

// Horner's rule from the highest coefficient, each step one fma_f32
// (threefry.py _poly_fma, the first step from p = 0).
template <int N>
__device__ __forceinline__ float poly_fma(float x, const double (&c)[N]) {
  float p = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) p = fma_f32(p, x, F32(c[i]));
  return p;
}

// threefry.py log1p_f32, for x >= -1 with x + 1 zero or a normal float32.
__device__ float log1p_f32(float x) {
  if (!(fabsf(x) < F32(0.41421356237309504880))) {
    return x == -1.0f ? -INFINITY : log_f32(__fadd_rn(x, 1.0f));
  }
  constexpr double kNum[7] = {
      4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
      6.5787325942061044846969E0,  2.9911919328553073277375E1,
      6.0949667980987787057556E1,  5.7112963590585538103336E1,
      2.0039553499201281259648E1};
  constexpr double kDen[7] = {
      1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
      2.2176239823732856465394E2,     3.0909872225312059774938E2,
      2.1642788614495947685003E2,     6.0118660497603843919306E1};
  const float x2 = __fmul_rn(x, x);
  const float q = __fdiv_rn(poly_fma(x, kNum), poly_fma(x, kDen));
  return __fadd_rn(x, fma_f32(-0.5f, x2, __fmul_rn(__fmul_rn(x, x2), q)));
}

// threefry.py erf_inv_f32: Giles' single-precision erfinv.
__device__ float erf_inv_f32(float x) {
  constexpr double kLt5[9] = {2.81022636e-08,  3.43273939e-07, -3.5233877e-06,
                              -4.39150654e-06, 0.00021858087,  -0.00125372503,
                              -0.00417768164,  0.246640727,    1.50140941};
  constexpr double kGe5[9] = {-0.000200214257, 0.000100950558, 0.00134934322,
                              -0.00367342844,  0.00573950773,  -0.0076224613,
                              0.00943887047,   1.00167406,     2.83297682};
  float w = -log1p_f32(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrt_f32(w), 3.0f);
  float p = lt ? F32(kLt5[0]) : F32(kGe5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma_f32(p, w, lt ? F32(kLt5[i]) : F32(kGe5[i]));
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

// f(normal) of one element's threefry bits: uniform on (-1, 1) (minval the
// float32 above -1, maxval 1), sqrt(2) * erf_inv, then sign(e) sqrt(|e|).
__device__ float noise_of_bits(uint32_t bits) {
  const float lo = -0x1.fffffep-1f;    // nextafter(-1, 0)
  const float f = __fsub_rn(__int_as_float(int32_t((bits >> 9) | 0x3F800000u)),
                            1.0f);
  // hi - lo rounds to 2 in float32
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  const float e = __fmul_rn(F32(1.4142135623730951), erf_inv_f32(u));
  const float sign = float(int(0.0f < e) - int(e < 0.0f));
  return __fmul_rn(sign, sqrt_f32(fabsf(e)));
}

// f(normal(k)[i]): the noise at flat index i of a draw under the key k.
__device__ __forceinline__ float noise_at(uint32_t k0, uint32_t k1,
                                          uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return noise_of_bits(x0 ^ x1);
}

// key: the network's noise key, int32[2]. w_mu, w_sigma, w: float32
// [rows, in_f]; b_mu, b_sigma, b: float32[features]; e: float32[in_f +
// features], e_in then e_out.
__global__ void __launch_bounds__(kThreads)
    noisy_weights_kernel(const int32_t* __restrict__ key, uint32_t fold,
                         const float* __restrict__ w_mu,
                         const float* __restrict__ w_sigma,
                         const float* __restrict__ b_mu,
                         const float* __restrict__ b_sigma,
                         float* __restrict__ w, float* __restrict__ b,
                         float* __restrict__ e, int in_f, int features,
                         int at, int rows) {
  __shared__ float e_tile[kRows];
  // the layer key, then ki (draw 0 of its split) and ko (draw 1)
  uint32_t l0 = 0, l1 = fold;
  threefry2x32(uint32_t(key[0]), uint32_t(key[1]), l0, l1);
  const int f0 = blockIdx.y * kRows;
  if (threadIdx.x < kRows) {
    const int o = f0 + threadIdx.x;
    float eo = 0.0f;
    if (o < features) {
      uint32_t ko0 = 0, ko1 = 1;
      threefry2x32(l0, l1, ko0, ko1);
      eo = noise_at(ko0, ko1, uint32_t(o));
      if (blockIdx.x == 0) {
        e[in_f + o] = eo;
        b[o] = fma_f32(b_sigma[o], eo, b_mu[o]);
      }
    }
    e_tile[threadIdx.x] = eo;
  }
  const int j = blockIdx.x * kThreads + threadIdx.x;
  float ei = 0.0f;
  if (j < in_f) {
    uint32_t ki0 = 0, ki1 = 0;
    threefry2x32(l0, l1, ki0, ki1);
    ei = noise_at(ki0, ki1, uint32_t(j));
    if (blockIdx.y == 0) e[j] = ei;
  }
  // the weight rows among the block's features (the same for every thread)
  const int r_lo = max(f0, at) - at;
  const int r_hi = min(min(f0 + kRows, features), at + rows) - at;
  if (r_lo >= r_hi) return;
  __syncthreads();
  if (j >= in_f) return;
  for (int r = r_lo; r < r_hi; ++r) {
    const size_t idx = size_t(r) * in_f + j;
    const float eps = __fmul_rn(ei, e_tile[at + r - f0]);
    w[idx] = fma_f32(w_sigma[idx], eps, w_mu[idx]);
  }
}

}  // namespace

// One layer's noisy weight and bias on the given stream of the given
// device. Returns the CUDA error of the launch (0 on success).
extern "C" int tetris_noise_launch(const void* key, unsigned int fold,
                                   const void* w_mu, const void* w_sigma,
                                   const void* b_mu, const void* b_sigma,
                                   void* w, void* b, void* e, int in_f,
                                   int features, int at, int rows, int device,
                                   void* stream) {
  if (in_f <= 0 || features <= 0 || rows <= 0 || at < 0 ||
      at + rows > features)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((in_f + kThreads - 1) / kThreads,
                  (features + kRows - 1) / kRows);
  noisy_weights_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), fold,
      static_cast<const float*>(w_mu), static_cast<const float*>(w_sigma),
      static_cast<const float*>(b_mu), static_cast<const float*>(b_sigma),
      static_cast<float*>(w), static_cast<float*>(b), static_cast<float*>(e),
      in_f, features, at, rows);
  return int(cudaGetLastError());
}
