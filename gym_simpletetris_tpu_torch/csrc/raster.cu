// Observation raster of the PyTorch port: packed board rows -> uint8 images,
// optionally accumulated in place.
//
// Replaces two Pallas TPU kernels of gym_simpletetris_tpu/ops/pallas_raster.py:
//   B. _build_kernel (entered through rasterize_rows_pallas): rows -> image;
//   C. _build_acc_kernel (entered through raster_accumulate): acc += image
//      with uint8 wraparound. The TPU kernel aliased acc to its output
//      (input_output_aliases); here the kernel adds into acc in place.
// One kernel serves both, selected by the `accumulate` flag.
//
// Pixel (p, q) of env b, with a0 / a1 the per-axis pixel -> cell maps of
// ops/raster.py (-1 gap, -2 border):
//   0                                      where a0[p] or a1[q] is border;
//   128 + 62 * cell(rows, a0[p], a1[q], b)  where both are cells;
//   128                                    otherwise.
// Rows are [H, NW, B] words, as in the engine: cell column c is bit
// (c + kXShift) & 31 of word (c + kXShift) >> 5 (NW == 1 for boards up to
// 24 wide). The kernel tests the bit in the packed row word directly, so no
// dense cell tensor exists (the TPU versions built one: a bf16 membership
// matmul in B, an XLA-side unpack before C, which is how the Pallas C took
// any width while B took single-word rows only).
//
// What bounds it on the H100: the image bytes. At 84 px an image is 7056 B
// per env, against 4 * H bytes of rows read, so the kernel is a store stream
// (plus a load stream with `accumulate`): at B = 4096, 29 MB written, about
// 9 us at the HBM rate of 3.35 TB/s. The design answers it with coalesced
// 4-byte stores: each thread builds 4 neighbouring pixels of the flat
// [B, size, size] array into one word, so a warp writes 128 contiguous bytes;
// accumulation is one 4-byte load and a per-byte wrapping add (__vadd4). The
// pixel maps sit in shared memory: a0, and for each pixel column the global
// bit g = c + kXShift of its cell, which names both the word (g >> 5) and the
// bit in it (g & 31); a warp's row reads hit one or two words of one env and
// are served from cache. Wide rows change only which word a pixel reads: at
// 84 px a board fits only up to 41 columns (NW <= 2), and the image bytes
// still dominate the 4 * H * NW bytes of rows. The body is one template:
// kOneWord (NW == 1) reads bit g of the row's only word with no word index.
// The per-pixel integer work bounds the kernel (29 MB in 72 us at B = 4096,
// 84 px, an eighth of HBM), so a per-pixel word multiply and a third shared
// map measured 11% slower on single-word images.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kXShift = 4;

template <bool kOneWord>
__global__ void raster_kernel(const int32_t* __restrict__ rows, int NW,
                              int B, const int32_t* __restrict__ a0,
                              const int32_t* __restrict__ a1, int S,
                              uint8_t* __restrict__ out, int accumulate) {
  // 2 * S entries: a0 (pixel row -> cell row), then for each pixel column
  // the global bit of its cell, or a1's -1 (gap) / -2 (border) code
  extern __shared__ int32_t maps[];
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x)
    maps[i] = i < S ? a0[i] : (a1[i - S] >= 0 ? a1[i - S] + kXShift
                                               : a1[i - S]);
  __syncthreads();

  const long long per_img = (long long)S * S;
  const long long total = per_img * B;
  const long long n_words = (total + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < n_words; w += stride) {
    const long long i0 = w * 4;
    long long b = i0 / per_img;
    int rem = int(i0 - b * per_img);
    int p = rem / S, q = rem - p * S;
    const int n = int(total - i0 < 4 ? total - i0 : 4);
    uint32_t word = 0u;
    for (int j = 0; j < n; ++j) {
      const int r = maps[p], g = maps[S + q];
      uint32_t v;
      if (r == -2 || g == -2) {
        v = 0u;
      } else if (r >= 0 && g >= 0) {
        const long long word =
            kOneWord ? (long long)r : (long long)r * NW + (g >> 5);
        const uint32_t bits = uint32_t(rows[word * B + b]);
        v = 128u + 62u * ((bits >> (g & 31)) & 1u);
      } else {
        v = 128u;
      }
      word |= v << (8 * j);
      if (++q == S) {
        q = 0;
        if (++p == S) { p = 0; ++b; }
      }
    }
    if (n == 4) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + i0);
      *dst = accumulate ? __vadd4(*dst, word) : word;
    } else {
      for (int j = 0; j < n; ++j) {
        const uint8_t v = uint8_t(word >> (8 * j));
        out[i0 + j] = accumulate ? uint8_t(out[i0 + j] + v) : v;
      }
    }
  }
}

}  // namespace

// rows int32[H, NW, B]; a0, a1 int32[S]; out uint8[B, S, S], 4-byte aligned.
// With accumulate != 0, out += image (mod 256) in place. Returns
// cudaGetLastError() of the launch; launches nothing for an empty batch.
extern "C" int tetris_raster_launch(const void* rows, int NW, int B,
                                    const void* a0, const void* a1, int S,
                                    void* out, int accumulate, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || S == 0) return 0;
  const long long n_words = ((long long)S * S * B + 3) / 4;
  const int threads = 256;
  long long blocks = (n_words + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond 32 per SM
  const size_t smem = size_t(2) * S * sizeof(int32_t);
  auto kernel = NW == 1 ? raster_kernel<true> : raster_kernel<false>;
  kernel<<<int(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), NW, B,
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1), S,
      static_cast<uint8_t*>(out), accumulate);
  return int(cudaGetLastError());
}
