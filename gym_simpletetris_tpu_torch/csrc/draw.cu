// The engine's spawn draw in one launch: the split of the state's key into
// the carry key and the draw key, and each env's draw r = 1 + bits mod
// sum(m) under the draw key.
//
// Replaces no Pallas kernel. The JAX package draws with jax.random
// (gym_simpletetris_tpu/core/engine.py:314-329: jax.random.split, then
// jax.random.bits and the modulo in draw_spawn_r), which XLA fuses into a
// kernel or two. The port's plain version (core/threefry.py split and
// draw_spawn_r, the oracle this kernel is held to) runs threefry2x32 as
// int64 tensor ops: about 358 launches a draw, two draws a rollout step, so
// the host's dispatch of those launches was most of a step's time and the
// card sat idle under it. This kernel was added to make a draw one launch.
//
// What it computes, bit for bit as the plain version (jax.random with
// threefry keys and jax_threefry_partitionable on):
// - the split: key i of jax.random.split(key) is threefry2x32(key, (0, i));
//   key 0 is the carry key, key 1 the draw key;
// - bits[i] = y0 ^ y1 of threefry2x32(draw_key, (0, env_offset + i)), env i
//   of the global batch's jax.random.bits(draw_key, (B_global,));
// - s[i] = sum over the 7 pieces of m = 5 + max(counts) - counts, that is
//   35 + 7 * max - sum(counts), in 32-bit arithmetic (the plain version
//   sums in int64 and casts to int32: the same bits);
// - r[i] = 1 + bits[i] mod s[i], the modulo unsigned.
//
// What bounds it on the H100: the launch. A draw reads 28 * B + 8 bytes
// and writes 4 * B + 8 (about 0.04 us of HBM time at B = 4096) and does
// two 20-round hashes a thread, so its device time is the launch latency.
// Its design keeps it one launch: every thread hashes the key into the
// draw key itself (a second launch would cost more than the 20 rounds),
// thread 0 alone writes the carry key, and a thread per env reads its
// column of the [7, B] counts, neighbouring threads on neighbouring words.
// With no counts (the caller injects r) it writes the carry key alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;

// key: the state's key, int32[2]. counts: int32[7, B], or null for the
// carry key alone. r: int32[B]. key_out: int32[2], the carry key.
__global__ void __launch_bounds__(kThreads)
    spawn_draw_kernel(const int32_t* __restrict__ key,
                      const int32_t* __restrict__ counts,
                      int32_t* __restrict__ r, int32_t* __restrict__ key_out,
                      int B, uint32_t env_offset) {
  const uint32_t k0 = uint32_t(key[0]), k1 = uint32_t(key[1]);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) {
    uint32_t c0 = 0, c1 = 0;
    threefry2x32(k0, k1, c0, c1);
    key_out[0] = int32_t(c0);
    key_out[1] = int32_t(c1);
  }
  if (counts == nullptr || i >= B) return;
  uint32_t d0 = 0, d1 = 1;
  threefry2x32(k0, k1, d0, d1);
  uint32_t x0 = 0, x1 = env_offset + uint32_t(i);
  threefry2x32(d0, d1, x0, x1);
  int32_t mx = counts[i];
  uint32_t sum = uint32_t(mx);
#pragma unroll
  for (int p = 1; p < 7; ++p) {
    const int32_t c = counts[size_t(p) * B + i];
    mx = max(mx, c);
    sum += uint32_t(c);
  }
  const uint32_t s = 35u + 7u * uint32_t(mx) - sum;
  r[i] = int32_t(1u + (x0 ^ x1) % s);
}

}  // namespace

// One spawn draw on the given stream of the given device: the carry key into
// key_out, and r for the B envs from env_offset when counts is not null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int tetris_draw_launch(const void* key, const void* counts,
                                  void* r, void* key_out, int B,
                                  int env_offset, int device, void* stream) {
  if (B < 0 || env_offset < 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  // one block at least, whose thread 0 writes the carry key
  const int blocks =
      counts != nullptr && B > kThreads ? (B + kThreads - 1) / kThreads : 1;
  spawn_draw_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(r), static_cast<int32_t*>(key_out), B,
      uint32_t(env_offset));
  return int(cudaGetLastError());
}
