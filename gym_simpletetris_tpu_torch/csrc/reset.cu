// The episode reset in one launch: for each env that the mask selects (every
// env without a mask), the state cleared as TetrisEngine.clear clears it and
// the empty emitted board; every other env keeps the state and emitted rows
// it had.
//
// Replaces no Pallas kernel. The JAX package resets with jnp.where over the
// state (gym_simpletetris_tpu/api/env.py apply_reset_mask, after
// core/engine.py engine_clear), which XLA fuses into the step's program. The
// port's plain version (api/env.py apply_reset_mask_plain, the oracle this
// kernel is held to) runs it as tensor ops: engine_clear's sampler, one-hot,
// fills and adds, then a torch.where for each of the 13 fields and one for
// the emitted rows, about 29 launches beside the clear's draw. At B = 4096
// those launches were most of a rollout step's host time and most of its
// kernels. This kernel was added to make the reset one launch after the
// draw kernel's.
//
// What it computes, bit for bit as the plain version, for env i:
// - reset (mask[i], or no mask): rows and emitted rows 0; piece =
//   #{p : cumsum(m)[p] < r[i]} with m = 5 + max(counts) - counts over the
//   cleared-from state's shape counts (m in 32-bit arithmetic, the cumsum
//   in 64, as torch.cumsum sums int32); rot 0, ax spawn_x, ay 0; time,
//   score, holes, lines_cleared and piece_height 0; lock and deaths the
//   cleared-from state's; shape counts the cleared-from state's plus the
//   spawned piece's one-hot (a piece of 7, from an r above sum(m), adds
//   nothing);
// - otherwise: the applied-to state's rows, 11 scalars and counts, and the
//   emitted rows, copied.
// The key is not the kernel's: the wrapper gives the new state the carry
// key of the clear's draw. Outputs are two new buffers, the state's (rows,
// counts and the 11 scalars) and the emitted rows', so that a state the
// caller keeps holds no emitted board; no input is written.
//
// Layout, as in the state: rows [H, NW, B] words ([H, B] at NW = 1), every
// per-env field a [B] row, counts [7, B]. One thread per env, the batch the
// minor axis, so neighbouring threads read and write neighbouring words of
// every row at every NW.
//
// What bounds it on the H100: its bytes. A carried env reads its rows and
// emitted rows (8 * H * NW bytes), 11 scalars and 7 counts, and the mask
// byte, and writes the same; a reset env reads the mask, r, lock, deaths
// and counts and writes as much. That is about 465 bytes an env at 10 x 20
// with few resets: 30 MB, 9 us at 3.35 TB/s, at B = 65,536; at B = 4096
// (1.9 MB) the launch's few microseconds bound it. The design streams: a
// thread's loads are independent of each other (the copy loop is unrolled,
// a reset env's loads predicated off), the inputs are read through the
// read-only path, and nothing is staged; no block waits on another.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kNScalars = 11;
// ops/cuda_reset.py: the state's per-env fields in SCALAR_FIELDS order
enum { sPiece, sRot, sAx, sAy, sLock, sTime, sScore, sHoles, sLines,
       sPieceHeight, sDeaths };

struct ResetIO {
  const int32_t* rows;                 // [H * NW, B] (null: no mask)
  const int32_t* in[kNScalars];        // (null: no mask)
  const int32_t* counts;               // [7, B] (null: no mask)
  const int32_t* from_lock;            // the cleared-from state's
  const int32_t* from_deaths;
  const int32_t* from_counts;          // [7, B]
  const int32_t* emitted;              // [H * NW, B] (null: no mask)
  const bool* mask;                    // [B], or null: every env resets
  const int32_t* r;                    // [B], the clear's spawn draws
  int32_t* rows_out;                   // [H * NW, B]
  int32_t* emitted_out;                // [H * NW, B]
  int32_t* counts_out;                 // [7, B]
  int32_t* out;                        // [11, B]
};

__global__ void __launch_bounds__(kThreads)
    reset_kernel(ResetIO io, int HN, int B, int32_t spawn_x) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const size_t b = size_t(B);
  const bool reset = io.mask == nullptr || io.mask[i];
  const int32_t* __restrict__ rows = io.rows;
  const int32_t* __restrict__ emitted = io.emitted;
  int32_t* __restrict__ rows_out = io.rows_out;
  int32_t* __restrict__ emitted_out = io.emitted_out;
#pragma unroll 4
  for (int k = 0; k < HN; ++k) {
    const size_t at = size_t(k) * b + i;
    rows_out[at] = reset ? 0 : __ldg(rows + at);
    emitted_out[at] = reset ? 0 : __ldg(emitted + at);
  }
  int32_t* __restrict__ out = io.out;
  int32_t* __restrict__ counts_out = io.counts_out;
  if (!reset) {
#pragma unroll
    for (int f = 0; f < kNScalars; ++f) out[f * b + i] = __ldg(io.in[f] + i);
#pragma unroll
    for (int p = 0; p < 7; ++p)
      counts_out[p * b + i] = __ldg(io.counts + p * b + i);
    return;
  }
  int32_t c[7];
  int32_t mx = INT32_MIN;
#pragma unroll
  for (int p = 0; p < 7; ++p) {
    c[p] = __ldg(io.from_counts + p * b + i);
    mx = max(mx, c[p]);
  }
  const int64_t r = __ldg(io.r + i);
  int64_t cum = 0;
  int32_t piece = 0;
#pragma unroll
  for (int p = 0; p < 7; ++p) {
    cum += int64_t(int32_t(5u + uint32_t(mx) - uint32_t(c[p])));
    piece += cum < r;
  }
#pragma unroll
  for (int p = 0; p < 7; ++p)
    counts_out[p * b + i] = int32_t(uint32_t(c[p]) + uint32_t(p == piece));
  out[sPiece * b + i] = piece;
  out[sRot * b + i] = 0;
  out[sAx * b + i] = spawn_x;
  out[sAy * b + i] = 0;
  out[sLock * b + i] = __ldg(io.from_lock + i);
  out[sTime * b + i] = 0;
  out[sScore * b + i] = 0;
  out[sHoles * b + i] = 0;
  out[sLines * b + i] = 0;
  out[sPieceHeight * b + i] = 0;
  out[sDeaths * b + i] = __ldg(io.from_deaths + i);
}

// The launch's arguments in one record (ops/cuda_reset._ARGS): the 19 input
// pointers (the applied-to state's rows, 11 scalars and counts; the
// cleared-from state's lock, deaths and counts; emitted rows, mask, r), the
// two output buffers, the stream; H, NW, B, spawn_x, the device and a pad
// word.
struct ResetArgs {
  const void* in[19];
  void* state;     // [H * NW + 7 + 11, B]: rows, counts, the scalars
  void* emitted;   // [H * NW, B]
  void* stream;
  int32_t H, NW, B, spawn_x, device, pad;
};
static_assert(sizeof(ResetArgs) == 200, "the record ops/cuda_reset.py packs");

}  // namespace

// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// arguments the kernel cannot take; launches nothing for B == 0.
extern "C" int tetris_reset_launch(const void* args) {
  const ResetArgs& a = *static_cast<const ResetArgs*>(args);
  const int H = a.H, NW = a.NW, B = a.B;
  if (H < 1 || NW < 1 || B < 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return int(err);
  if (B == 0) return 0;
  ResetIO io;
  const int32_t* const* in = reinterpret_cast<const int32_t* const*>(a.in);
  io.rows = in[0];
  for (int f = 0; f < kNScalars; ++f) io.in[f] = in[1 + f];
  io.counts = in[12];
  io.from_lock = in[13];
  io.from_deaths = in[14];
  io.from_counts = in[15];
  io.emitted = in[16];
  io.mask = static_cast<const bool*>(a.in[17]);
  io.r = in[18];
  if (io.from_lock == nullptr || io.from_deaths == nullptr ||
      io.from_counts == nullptr || io.r == nullptr || a.state == nullptr ||
      a.emitted == nullptr)
    return int(cudaErrorInvalidValue);
  if (io.mask != nullptr) {   // a carried env reads the applied-to state
    if (io.rows == nullptr || io.counts == nullptr || io.emitted == nullptr)
      return int(cudaErrorInvalidValue);
    for (int f = 0; f < kNScalars; ++f)
      if (io.in[f] == nullptr) return int(cudaErrorInvalidValue);
  }
  const int HN = H * NW;
  const size_t n = size_t(HN) * B;
  int32_t* o = static_cast<int32_t*>(a.state);
  io.rows_out = o;
  io.counts_out = o + n;
  io.out = o + n + 7 * size_t(B);
  io.emitted_out = static_cast<int32_t*>(a.emitted);
  const int blocks = (B + kThreads - 1) / kThreads;
  reset_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(
      io, HN, B, a.spawn_x);
  return int(cudaGetLastError());
}
