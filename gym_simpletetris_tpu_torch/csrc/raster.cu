// Observation raster of the PyTorch port: packed board rows -> uint8 images,
// optionally accumulated in place.
//
// Replaces two Pallas TPU kernels of gym_simpletetris_tpu/ops/pallas_raster.py:
//   B. _build_kernel (entered through rasterize_rows_pallas): rows -> image;
//   C. _build_acc_kernel (entered through raster_accumulate): acc += image
//      with uint8 wraparound. The TPU kernel aliased acc to its output
//      (input_output_aliases); here the kernel adds into acc in place.
// One kernel body serves both; kAcc selects C at compile time.
//
// Pixel (p, q) of env b, with a0 / a1 the per-axis pixel -> cell maps of
// ops/raster.py (-1 gap, -2 border):
//   0                                      where a0[p] or a1[q] is border;
//   128 + 62 * cell(rows, a0[p], a1[q], b)  where both are cells;
//   128                                    otherwise.
// Rows are [H, NW, B] words, as in the engine: cell column c is bit
// (c + kXShift) & 31 of word (c + kXShift) >> 5 (NW == 1 for boards up to
// 24 wide). The kernel tests bits of the packed row words, so no dense cell
// tensor exists (the TPU versions built one).
//
// What bounds it on the H100: the image bytes. At 84 px an image is 7056 B
// per env against 4 * H * NW bytes of rows, so B is a store stream and C a
// load stream beside a store stream: at B = 4096, 28.9 MB written (and as
// much read by C), 8.7 us (17.4 us) at the HBM rate of 3.35 TB/s. The first
// design computed every pixel from the maps (a 64-bit divide per 4 bytes,
// map loads, a branchy cell test and a dependent row-word load per pixel)
// and reached an eighth of that rate: integer work per pixel bound it.
//
// This design takes that work out of the pixel path:
// - A pixel row depends only on its class: cell row r, gap or border. A
//   block builds the S-byte pattern of each cell row of an env once, 4
//   pixels (one word) a thread. Four neighbouring pixels touch at most two
//   cells (a cell and its gap span at least 2 px), so a static descriptor
//   per pattern word, built once per block from the maps, names those
//   cells' global bits g (word g >> 5, bit g & 31 of a row) and the bytes
//   each one lights; a pattern word is then two shared-memory row-word
//   loads, two bit tests and two multiply-adds onto the gap row's word.
//   Pixel row p is pattern[class(p)].
// - A block takes work items (env, band of pixel rows) in a grid-stride
//   loop; the grid is sized from the SM count and the occupancy, and the
//   env and band come from the item index, one divide per item. At 84 and
//   160 px a band is the whole image. Larger images are cut into bands of
//   whole cell rows (host side: ops/cuda_raster.raster_bands), so that a
//   band's patterns fit in shared memory at every size up to 4096 px and a
//   512 px batch spreads over the SMs. The per-item state (row words, row
//   offsets, patterns) is double-buffered, so an item costs two barriers;
//   the next item's row words are loaded while this one is built and
//   written, and C issues its loads of acc before it builds the patterns.
// - 16 bytes move per thread per access: an item's bytes are cut into
//   16-byte-aligned uint4 chunks, stored coalesced (a warp writes 512
//   contiguous bytes). C loads up to kUnroll chunks of acc per thread
//   before it adds (__vadd4: per-byte wraparound within each 32-bit word)
//   and stores. Where every image is one band that starts on a 16-byte
//   boundary (84 and 160 px into a fresh tensor), the chunks of every image
//   read the same pattern offsets, so a per-block table holds each chunk's
//   four (kTable): a chunk is one table load, four pattern loads and a
//   store. Otherwise a thread walks its chunks' pixel rows and columns
//   without dividing; a head and a tail of under 16 bytes (an acc view at
//   a 4-byte offset, an image that ends mid-chunk) go kUnit bytes at a time.
// - Where the image width S is a multiple of 4 (84, 160, 512 px) no 4-byte
//   word straddles two pixel rows, so a chunk is four aligned pattern words
//   (kUnit = 4). Other widths (83 px) assemble each chunk byte by byte from
//   the same patterns (kUnit = 1): a narrower path, the same uint4 stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kXShift = 4;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // resident blocks per SM: at most 64 registers
constexpr int kUnroll = 4;      // chunks of acc in flight per thread in C

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Dynamic shared memory, as byte offsets. SP, the pattern stride, is S
// rounded up to 16. Per block: a0 (int32[SP]), the pattern-word
// descriptors (int4[SP / 4]) and, with the chunk table, four uint16 pattern
// offsets per 16-byte chunk of an image. Per item, twice (double-buffered):
// the row words of the band (int32[R * NW]), the pattern offset of each of
// its pixel rows (int32[SP]) and R + 2 patterns of SP bytes: the band's
// cell rows, then the gap row, then the border's zeros. Offsets into a
// buffer's patterns are relative to its first pattern.
struct Layout {
  int SP, a0, desc, table, buf, buf_bytes, words, rowoff, pat, bytes;
  __host__ __device__ Layout(int S, int R, int NW, bool table_on) {
    SP = pad16(S);
    a0 = 0;
    desc = a0 + 4 * SP;
    table = desc + 4 * SP;
    buf = table + (table_on ? pad16(S * S / 2) : 0);
    words = 0;
    rowoff = pad16(4 * R * NW);
    pat = rowoff + 4 * SP;
    buf_bytes = pat + (R + 2) * SP;
    bytes = buf + 2 * buf_bytes;
  }
};

// The kernel takes a chunk table only where it fits: 16-bit offsets into
// the patterns and at most kTableBytes of table.
constexpr int kTableBytes = 16384;

__host__ __device__ inline bool table_fits(int S, int R) {
  return S % 4 == 0 && S * S / 2 <= kTableBytes && (R + 2) * pad16(S) < 65536;
}

__device__ __forceinline__ uint32_t row_bit(const int32_t* w, int g) {
  return (uint32_t(w[g >> 5]) >> (g & 31)) & 1u;
}

// The kUnit bytes at byte o of the band (o a multiple of kUnit).
template <int kUnit>
__device__ __forceinline__ uint32_t unit_at(const uint8_t* pat,
                                            const int32_t* rowoff, int S,
                                            int o) {
  const int p = o / S;
  const uint8_t* src = pat + rowoff[p] + (o - p * S);
  return kUnit == 4 ? *reinterpret_cast<const uint32_t*>(src) : *src;
}

template <int kUnit, bool kAcc>
__device__ __forceinline__ void put_unit(uint8_t* dst, uint32_t v) {
  if (kUnit == 4) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    *d = kAcc ? __vadd4(*d, v) : v;
  } else {
    *dst = kAcc ? uint8_t(*dst + v) : uint8_t(v);
  }
}

// The 16 bytes that start at column q of the band's pixel row p.
template <int kUnit>
__device__ __forceinline__ uint4 chunk_at(const uint8_t* pat,
                                          const int32_t* rowoff, int S, int p,
                                          int q) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const uint8_t* src = pat + rowoff[p] + q;
#pragma unroll
  for (int j = 0; j < 16 / kUnit; ++j) {
    if (kUnit == 4)
      w[j] = *reinterpret_cast<const uint32_t*>(src);
    else
      w[j >> 2] |= uint32_t(*src) << (8 * (j & 3));
    src += kUnit;
    q += kUnit;
    if (q == S && j + 1 < 16 / kUnit) {
      q = 0;
      src = pat + rowoff[++p];
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 vadd4(uint4 a, uint4 b) {
  return make_uint4(__vadd4(a.x, b.x), __vadd4(a.y, b.y), __vadd4(a.z, b.z),
                    __vadd4(a.w, b.w));
}

template <int kUnit, bool kAcc, bool kTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_kernel(const int32_t* __restrict__ rows, int H, int NW, int B,
              const int32_t* __restrict__ a0g, const int32_t* __restrict__ a1g,
              const int32_t* __restrict__ bands, int n_bands, int R, int S,
              uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(S, R, NW, kTable);
  int32_t* a0 = reinterpret_cast<int32_t*>(smem + L.a0);
  int4* desc = reinterpret_cast<int4*>(smem + L.desc);
  uint2* table = reinterpret_cast<uint2*>(smem + L.table);
  const int t = threadIdx.x;
  const int SW = (S + 3) / 4;          // pattern words that hold pixels
  const int SP4 = L.SP / 4;

  // Static tables. A pattern word's descriptor: the global bits g1, g2 of
  // the (at most two) cells among its four pixel columns and, for each, 62
  // in the bytes it lights; an absent cell is bit 0 lighting nothing.
  for (int q = t; q < L.SP; q += kThreads) a0[q] = q < S ? a0g[q] : -2;
  for (int q4 = t; q4 < SP4; q4 += kThreads) {
    int g[2] = {0, 0};
    uint32_t m[2] = {0u, 0u}, gap = 0u;
    int n = 0;
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * q4 + j;
      const int c = q < S ? a1g[q] : -2;
      if (c != -2) gap |= 128u << (8 * j);
      if (c < 0) continue;
      if (n == 0 || c + kXShift != g[n - 1]) g[n++] = c + kXShift;
      m[n - 1] |= 62u << (8 * j);
    }
    desc[q4] = make_int4(g[0], g[1], int(m[0]), int(m[1]));
    for (int b = 0; b < 2; ++b) {
      uint32_t* pat = reinterpret_cast<uint32_t*>(
          smem + L.buf + b * L.buf_bytes + L.pat);
      pat[R * SP4 + q4] = gap;
      pat[(R + 1) * SP4 + q4] = 0u;
    }
  }
  __syncthreads();   // a0 (the row offsets below read it)
  if (kTable) {
    // one band of R == H cell rows, every image 16-byte aligned
    for (int c = t; c < S * S / 16; c += kThreads) {
      int p = (16 * c) / S, q = 16 * c - p * S;
      uint32_t off[4];
      for (int j = 0; j < 4; ++j) {
        const int r = a0[p];
        off[j] = (r >= 0 ? r : (r == -1 ? R : R + 1)) * L.SP + q;
        q += 4;
        if (q == S) {
          q = 0;
          ++p;
        }
      }
      table[c] = make_uint2(off[0] | off[1] << 16, off[2] | off[3] << 16);
    }
  }

  // The pattern build: thread t keeps pattern word q4 and builds it for
  // cell rows r, r + r_step, ... (where a row has more words than the block
  // threads, it takes words t, t + kThreads, ... of every row).
  int b_q0 = t, b_qstep = kThreads, b_r0 = 0, b_rstep = 1;
  if (SW <= kThreads) {
    b_rstep = kThreads / SW;
    b_r0 = t / SW;
    b_q0 = b_r0 < b_rstep ? t % SW : SW;
    b_qstep = SW;
  }
  // The output walk steps kThreads chunks, 16 * kThreads bytes, at a time.
  const int o_dp = (16 * kThreads) / S, o_dq = (16 * kThreads) % S;

  const int n_items = B * n_bands;
  auto n_words = [&](int item) {
    const int k = item % n_bands;
    return min(R, H - k * R) * NW;
  };
  auto row_word = [&](int item, int i) {
    const int e = item / n_bands, k = item - e * n_bands;
    return rows[(long long)(k * R * NW + i) * B + e];
  };
  int32_t next_word = 0;
  if (t < n_words(blockIdx.x)) next_word = row_word(blockIdx.x, t);

  for (int item = blockIdx.x, b = 0; item < n_items;
       item += gridDim.x, b ^= 1) {
    uint8_t* buf = smem + L.buf + b * L.buf_bytes;
    int32_t* words = reinterpret_cast<int32_t*>(buf + L.words);
    int32_t* rowoff = reinterpret_cast<int32_t*>(buf + L.rowoff);
    const uint8_t* pat = buf + L.pat;
    const int e = item / n_bands, k = item - e * n_bands;
    const int r0 = k * R, nr = min(R, H - r0);
    const int p_lo = bands[k], n_rows = bands[k + 1] - p_lo;
    if (t < nr * NW) words[t] = next_word;
    for (int i = t + kThreads; i < nr * NW; i += kThreads)
      words[i] = row_word(item, i);
    if (!kTable) {
      for (int p = t; p < n_rows; p += kThreads) {
        const int c = a0[p_lo + p];
        rowoff[p] = (c >= 0 ? c - r0 : (c == -1 ? R : R + 1)) * L.SP;
      }
    }
    __syncthreads();   // this item's words, offsets (and the static tables)
    const int next = item + gridDim.x;
    if (next < n_items && t < n_words(next)) next_word = row_word(next, t);

    // The band's bytes: a head up to the first 16-byte boundary, uint4
    // chunks, a tail. C loads its first chunks of acc before the build.
    uint8_t* dst = out + ((long long)e * S + p_lo) * S;
    const int len = n_rows * S;
    const int head =
        kTable ? 0
               : min(len, int((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                              15));
    const int n_chunks = (len - head) >> 4;
    const int tail = head + 16 * n_chunks;
    uint4* body = reinterpret_cast<uint4*>(dst + head);
    uint4 acc[kUnroll];
    if (kAcc) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t + u * kThreads < n_chunks) acc[u] = body[t + u * kThreads];
    }

    uint32_t* pat32 = reinterpret_cast<uint32_t*>(buf + L.pat);
    for (int q4 = b_q0; q4 < SW; q4 += b_qstep) {
      const int4 d = desc[q4];
      const uint32_t gap = pat32[R * SP4 + q4];
      for (int r = b_r0; r < nr; r += b_rstep) {
        const int32_t* w = words + r * NW;
        pat32[r * SP4 + q4] = gap + row_bit(w, d.x) * uint32_t(d.z) +
                              row_bit(w, d.y) * uint32_t(d.w);
      }
    }
    __syncthreads();   // this item's patterns

    if (!kTable) {
      if (t < head / kUnit)
        put_unit<kUnit, kAcc>(dst + t * kUnit,
                              unit_at<kUnit>(pat, rowoff, S, t * kUnit));
      if (t < (len - tail) / kUnit)
        put_unit<kUnit, kAcc>(
            dst + tail + t * kUnit,
            unit_at<kUnit>(pat, rowoff, S, tail + t * kUnit));
    }
    int p = 0, q = 0;   // the walk's pixel row (in the band) and column
    if (!kTable) {
      p = (head + 16 * t) / S;
      q = head + 16 * t - p * S;
    }
    for (int c0 = t; c0 < n_chunks; c0 += kUnroll * kThreads) {
      if (kAcc && c0 != t) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c0 + u * kThreads < n_chunks) acc[u] = body[c0 + u * kThreads];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) {
          uint4 v;
          if (kTable) {
            const uint2 o = table[c];
            v = make_uint4(
                *reinterpret_cast<const uint32_t*>(pat + (o.x & 0xffffu)),
                *reinterpret_cast<const uint32_t*>(pat + (o.x >> 16)),
                *reinterpret_cast<const uint32_t*>(pat + (o.y & 0xffffu)),
                *reinterpret_cast<const uint32_t*>(pat + (o.y >> 16)));
          } else {
            v = chunk_at<kUnit>(pat, rowoff, S, p, q);
          }
          body[c] = kAcc ? vadd4(acc[u], v) : v;
        }
        if (!kTable) {
          q += o_dq;
          p += o_dp;
          if (q >= S) {
            q -= S;
            ++p;
          }
        }
      }
    }
  }
}

template <int kUnit, bool kAcc, bool kTable>
cudaError_t launch(const int32_t* rows, int H, int NW, int B,
                   const int32_t* a0, const int32_t* a1, const int32_t* bands,
                   int n_bands, int R, int S, uint8_t* out, int device,
                   cudaStream_t stream) {
  auto kernel = raster_kernel<kUnit, kAcc, kTable>;
  const int smem = Layout(S, R, NW, kTable).bytes;
  // Resident blocks on the card at this shared-memory size, asked once per
  // size and device. The library is called through ctypes, which releases
  // the GIL, so two host threads may launch at once: the cache and the
  // launch (whose shared-memory limit is an attribute of the kernel) are
  // taken under one lock per kernel instance.
  static std::mutex mu;
  static int cached_smem = -1, cached_device = -1;
  static long long resident = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (smem != cached_smem || device != cached_device) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    cached_smem = smem;
    cached_device = device;
  }
  const long long items = (long long)B * n_bands;
  const int grid = int(items < resident ? items : resident);
  kernel<<<grid, kThreads, smem, stream>>>(rows, H, NW, B, a0, a1, bands,
                                           n_bands, R, S, out);
  return cudaGetLastError();
}

template <bool kAcc>
cudaError_t dispatch(const int32_t* rows, int H, int NW, int B,
                     const int32_t* a0, const int32_t* a1,
                     const int32_t* bands, int n_bands, int R, int S,
                     uint8_t* out, int device, cudaStream_t stream) {
  if (S % 4 != 0)
    return launch<1, kAcc, false>(rows, H, NW, B, a0, a1, bands, n_bands, R,
                                  S, out, device, stream);
  if (n_bands == 1 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      table_fits(S, R))
    return launch<4, kAcc, true>(rows, H, NW, B, a0, a1, bands, n_bands, R,
                                 S, out, device, stream);
  return launch<4, kAcc, false>(rows, H, NW, B, a0, a1, bands, n_bands, R, S,
                                out, device, stream);
}

}  // namespace

// rows int32[H, NW, B]; a0, a1 int32[S]; bands int32[n_bands + 1], the
// first pixel row of each band of R cell rows and S at the end
// (ops/cuda_raster.raster_bands); out uint8[B, S, S], 4-byte aligned. With
// accumulate != 0, out += image (mod 256) in place. Returns the CUDA error
// of the launch (cudaGetLastError()); launches nothing for an empty batch.
extern "C" int tetris_raster_launch(const void* rows, int H, int NW, int B,
                                    const void* a0, const void* a1,
                                    const void* bands, int n_bands, int R,
                                    int S, void* out, int accumulate,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || S == 0) return 0;
  auto args = [&](auto fn) {
    return fn(static_cast<const int32_t*>(rows), H, NW, B,
              static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
              static_cast<const int32_t*>(bands), n_bands, R, S,
              static_cast<uint8_t*>(out), device,
              static_cast<cudaStream_t>(stream));
  };
  err = accumulate ? args(dispatch<true>) : args(dispatch<false>);
  return int(err);
}
