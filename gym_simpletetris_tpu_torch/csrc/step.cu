// Engine transition kernel of the PyTorch port: one thread per env.
//
// Replaces the Pallas TPU kernel gym_simpletetris_tpu/ops/pallas_step.py
// (_build_kernel, entered through engine_step_pallas). It computes what
// gym_simpletetris_tpu/core/engine.py::engine_step computes, at every board
// width: the in-place move candidate the action asks for and its collision,
// soft drop / hard drop / gravity against the post-action pose, the
// lock-delay FSM, burn, stable line compaction, scoring (NES / high /
// plain), death with the -100 overwrite, holes and the height penalties at
// lock, the count-balanced spawn from a precomputed draw, and the emitted
// board beside the piece-erased persistent board. The Pallas kernel covered
// single-word boards only (width <= 24); the JAX package ran wider boards
// in XLA. Here one kernel body serves both.
//
// Board layout, as in the JAX state: rows [H, NW, B] words, global bit
// x + kXShift of a row in word (x + kXShift) >> 5; NW == 1 is the flat
// [H, B] of single-word boards. The body is one template: kOneWord fixes
// NW = 1 at compile time, so the single-word instance has no word loops and
// no second mask word; the other instance takes NW at run time (up to 33
// at width 1024). Per-word state cannot live in registers at that size, so
// words are streamed from memory: thread b reads rows[(y * NW + w) * B + b],
// and a warp still reads 32 neighbouring words.
//
// A piece mask row holds at most 7 bits, at global bits s .. s + 6 with
// s = ax + 1, so it touches at most words s >> 5 and (s >> 5) + 1. A pose
// is held as that base word index and two words per relative row (Masks),
// the funnel shift of core/engine.py::piece_masks; a word at index >= NW
// does not exist and takes nothing, so no load ever reads word NW. A bit
// outside [kXShift, kXShift + width) collides; each word's in-board bits
// are computed from the width (valid_word). At width 25 word 1 holds only
// guard bits: its valid bits are 0, so a row is full on word 0 alone.
//
// What bounds it on the H100: memory and launch latency. A step moves about
// 4 * (3 * H * NW + 2 * 11 + 2 * 7 + 4) bytes per env (read the board,
// write the board and the emitted board, the per-env scalars and counts) and
// does a few hundred integer operations per env and word. At B = 4096 that
// is under 2 MB for H = 20 and NW = 1 (under 3 MB at NW = 2), well under a
// microsecond of HBM time, so one launch of a few microseconds is the cost.
// The design answers it by doing the whole transition in one launch with no
// intermediate tensors: the state is read once, each output written once,
// and everything between lives in registers (the locked board is written
// once and re-read by the same thread).
//
// What the TPU kernel needed and this one does not (ops/pallas_step.py:24-31):
// the (piece, rot) mask lookup is a __constant__ table index, not a one-hot
// f32 matmul; a window row is a direct read, not a one-hot select; prefix OR
// and prefix sum are running loops; popcount is __popc; hard drop is a loop
// over the collision profile; line compaction walks a write pointer up from
// the bottom. Any B works: the tail block is masked.
//
// All board words are uint32_t here. The rows arrive as int32 tensors that
// carry the uint32 bits, and masks reach bit 31, so no signed shift ever
// touches them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNRows = 7;   // relative rows spanned by any piece
constexpr int kDyOff = 3;   // relative row k covers dy = k - kDyOff
constexpr int kXShift = 4;  // column x lives at bit x + kXShift
constexpr int kNScalars = 11;

// ROWMASKS_FLAT of core/pieces.py, indexed [piece * 4 + rot][k]: bit dx + 3
// is set for each cell of relative row k. tests/test_torch_tables.py parses
// this initializer and holds it against the JAX package's table.
__constant__ uint8_t c_rowmasks[28][kNRows] = {
    {0, 0, 8, 28, 0, 0, 0},
    {0, 0, 8, 24, 8, 0, 0},
    {0, 0, 0, 28, 8, 0, 0},
    {0, 0, 8, 12, 8, 0, 0},
    {0, 8, 8, 12, 0, 0, 0},
    {0, 0, 8, 56, 0, 0, 0},
    {0, 0, 0, 24, 8, 8, 0},
    {0, 0, 0, 14, 8, 0, 0},
    {0, 8, 8, 24, 0, 0, 0},
    {0, 0, 0, 56, 8, 0, 0},
    {0, 0, 0, 12, 8, 8, 0},
    {0, 0, 8, 14, 0, 0, 0},
    {0, 0, 24, 12, 0, 0, 0},
    {0, 0, 8, 24, 16, 0, 0},
    {0, 0, 0, 24, 12, 0, 0},
    {0, 0, 4, 12, 8, 0, 0},
    {0, 0, 12, 24, 0, 0, 0},
    {0, 0, 16, 24, 8, 0, 0},
    {0, 0, 0, 12, 24, 0, 0},
    {0, 0, 8, 12, 4, 0, 0},
    {8, 8, 8, 8, 0, 0, 0},
    {0, 0, 0, 120, 0, 0, 0},
    {0, 0, 0, 8, 8, 8, 8},
    {0, 0, 0, 15, 0, 0, 0},
    {0, 0, 12, 12, 0, 0, 0},
    {0, 0, 24, 24, 0, 0, 0},
    {0, 0, 0, 24, 24, 0, 0},
    {0, 0, 0, 12, 12, 0, 0},
};

__constant__ int c_nes_scores[5] = {0, 40, 100, 300, 1200};

// Actions (value_action_map of the reference).
enum { kLeft = 0, kRight = 1, kHard = 2, kSoft = 3, kRotL = 4, kRotR = 5 };

// EnvConfig flags, packed by ops/cuda_step.py.
enum {
  kRewardStep = 1, kPenHeight = 2, kPenHeightInc = 4, kAdvClears = 8,
  kHighScoring = 16, kPenHoles = 32, kPenHolesInc = 64, kStepReset = 128,
};

// Scalar slots, in the order of state.SCALAR_FIELDS.
enum { sPiece, sRot, sAx, sAy, sLock, sTime, sScore, sHoles, sLines, sPh,
       sDeaths };

struct StepIO {
  const int32_t* rows;                  // [H, NW, B]
  const int32_t* scal_in[kNScalars];    // each [B]
  const int32_t* counts;                // [7, B]
  const int32_t* action;                // [B]
  const int32_t* r_draw;                // [B]
  int32_t* rows_out;                    // [H, NW, B], piece-erased board
  int32_t* scal_out;                    // [11, B]
  int32_t* counts_out;                  // [7, B]
  int32_t* emitted;                     // [H, NW, B], piece burned in
  float* reward;                        // [B]
  bool* done;                           // [B]
};

struct StepCfg {
  int H, NW, B, width, lock_mod, spawn_x, flags;
};

__device__ __forceinline__ size_t at(const StepCfg& c, int nw, int y, int w,
                                     int b) {
  return (size_t(y) * nw + w) * c.B + b;
}

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

// In-board column bits of word w: global bits [kXShift, kXShift + width).
__device__ __forceinline__ uint32_t valid_word(const StepCfg& c, int w) {
  return low_bits(kXShift + c.width - 32 * w) & ~low_bits(kXShift - 32 * w);
}

// A pose's board-row masks: relative row k covers board row ay + k - kDyOff
// and holds lo[k] in word `base` and hi[k] in word base + 1; vlo / vhi are
// those words' in-board bits (0 for a word that does not exist).
struct Masks {
  int base;
  uint32_t vlo, vhi;
  uint32_t lo[kNRows], hi[kNRows];
};

// Masks of (piece, rot) at anchor column ax. An index outside the table
// gives an empty piece, as the JAX one-hot lookup does. The anchor shift
// s = ax + kXShift - 3 is >= 0 for every reachable pose; below 0 a single
// word takes nothing (the JAX uint32 shift) and word 0 of a wide row takes
// m >> -s (the JAX funnel shift).
template <bool kOneWord>
__device__ __forceinline__ void piece_masks(int piece, int rot, int ax,
                                            const StepCfg& c, Masks& M) {
  const int nw = kOneWord ? 1 : c.NW;
  const int pr = piece * 4 + (rot & 3);
  const bool ok = pr >= 0 && pr < 28;
  const int prc = ok ? pr : 0;
  const int s = ax + (kXShift - 3);
  M.base = s >= 0 ? (s >> 5) : 0;
  const bool has_lo = M.base < nw, has_hi = !kOneWord && M.base + 1 < nw;
  M.vlo = has_lo ? valid_word(c, M.base) : 0u;
  M.vhi = has_hi ? valid_word(c, M.base + 1) : 0u;
#pragma unroll
  for (int k = 0; k < kNRows; ++k) {
    const uint32_t m = ok ? uint32_t(c_rowmasks[prc][k]) : 0u;
    uint64_t v = 0;
    if (s >= 0) v = uint64_t(m) << (s & 31);
    else if (!kOneWord && s > -32) v = m >> -s;
    M.lo[k] = has_lo ? uint32_t(v) : 0u;
    M.hi[k] = has_hi ? uint32_t(v >> 32) : 0u;
  }
}

// is_occupied of the reference for a whole piece at anchor row ay: a cell
// row with y < 0 is skipped before any x check; otherwise it collides if it
// has a cell outside the columns, any cell at y >= H, or a cell on the board.
__device__ __forceinline__ bool collides(const int32_t* rows, const Masks& M,
                                         int ay, const StepCfg& c, int nw,
                                         int b) {
#pragma unroll
  for (int k = 0; k < kNRows; ++k) {
    const int y = ay + k - kDyOff;
    const uint32_t lo = M.lo[k], hi = M.hi[k];
    if (y < 0 || (lo | hi) == 0u) continue;
    if (((lo & ~M.vlo) | (hi & ~M.vhi)) != 0u || y >= c.H) return true;
    if (lo != 0u && (uint32_t(rows[at(c, nw, y, M.base, b)]) & lo) != 0u)
      return true;
    if (hi != 0u && (uint32_t(rows[at(c, nw, y, M.base + 1, b)]) & hi) != 0u)
      return true;
  }
  return false;
}

// The JAX engine's collision profile read at one index: False outside [0, H].
__device__ __forceinline__ bool profile_at(const int32_t* rows,
                                           const Masks& M, int idx,
                                           const StepCfg& c, int nw, int b) {
  return idx >= 0 && idx <= c.H && collides(rows, M, idx, c, nw, b);
}

// Word w of the piece burned into board row y (in-board bits only).
__device__ __forceinline__ uint32_t piece_word(const Masks& M, int y, int ay,
                                               int w) {
  const int k = y - ay + kDyOff;
  if (k < 0 || k >= kNRows) return 0u;
  if (w == M.base) return M.lo[k] & M.vlo;
  if (w == M.base + 1) return M.hi[k] & M.vhi;
  return 0u;
}

template <bool kOneWord>
__global__ void step_kernel(StepIO io, StepCfg c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= c.B) return;
  const int H = c.H, B = c.B;
  const int nw = kOneWord ? 1 : c.NW;

  const int piece = io.scal_in[sPiece][b];
  const int rot = io.scal_in[sRot][b];
  const int ax = io.scal_in[sAx][b];
  const int ay = io.scal_in[sAy][b];
  const int lock = io.scal_in[sLock][b];
  const int action = io.action[b];
  Masks m;

  // -- action: the one candidate it asks for, at the current anchor row ----
  int ax1 = ax, rot1 = rot & 3;
  if (action == kLeft || action == kRight) {
    const int nx = ax + (action == kLeft ? -1 : 1);
    piece_masks<kOneWord>(piece, rot, nx, c, m);
    if (!collides(io.rows, m, ay, c, nw, b)) ax1 = nx;
  } else if (action == kRotL || action == kRotR) {
    const int nr = (rot + (action == kRotL ? -1 : 1)) & 3;
    piece_masks<kOneWord>(piece, nr, ax, c, m);
    if (!collides(io.rows, m, ay, c, nw, b)) rot1 = nr;
  }

  // -- drops against the post-action pose -------------------------------------
  Masks m1;
  piece_masks<kOneWord>(piece, rot1, ax1, c, m1);
  int ay1 = ay;
  if (action == kHard) {
    // first blocked profile row below the anchor; profile[H] always blocks
    ay1 = H + 1;
    for (int y = max(ay + 1, 0); y <= H; ++y)
      if (collides(io.rows, m1, y, c, nw, b)) { ay1 = y - 1; break; }
  } else if (action == kSoft && !profile_at(io.rows, m1, ay + 1, c, nw, b)) {
    ay1 = ay + 1;
  }
  // gravity: one extra soft drop every step
  const int ay2 = ay1 + (profile_at(io.rows, m1, ay1 + 1, c, nw, b) ? 0 : 1);
  const int lock0 = ((c.flags & kStepReset) && ay2 != ay1) ? 0 : lock;

  // -- lock-delay FSM --------------------------------------------------------
  const bool resting = profile_at(io.rows, m1, ay2 + 1, c, nw, b);
  int lock1 = lock0;
  if (resting) {
    lock1 = (lock0 + 1) % c.lock_mod;
    if (lock1 < 0) lock1 += c.lock_mod;                 // floor modulo
  }
  const bool locked = resting && lock1 == 0;

  // -- lock: burn the piece and compact full rows, bottom up, stable ---------
  // rows_after lives in rows_out when the piece locked, else it is the input.
  // Each row is written at the write pointer as it is read; a full row does
  // not advance the pointer, so the next kept row (or the zero fill above
  // the last one) overwrites it.
  int n_clear = 0;
  if (locked) {
    int wp = H - 1;
    for (int y = H - 1; y >= 0; --y) {
      bool full = true;
      for (int w = 0; w < nw; ++w) {
        const uint32_t valid = valid_word(c, w);
        const uint32_t v = uint32_t(io.rows[at(c, nw, y, w, b)]) |
                           piece_word(m1, y, ay2, w);
        full = full && (v & valid) == valid;
        io.rows_out[at(c, nw, wp, w, b)] = int32_t(v);
      }
      if (full) ++n_clear;
      else --wp;
    }
    for (; wp >= 0; --wp)
      for (int w = 0; w < nw; ++w) io.rows_out[at(c, nw, wp, w, b)] = 0;
  }
  const int32_t* after = locked ? io.rows_out : io.rows;

  float reward = (c.flags & kRewardStep) ? 1.0f : 0.0f;
  int score_inc;
  if (c.flags & kAdvClears) {
    score_inc = n_clear <= 4 ? c_nes_scores[n_clear] : 0;
    reward = reward + 2.5f * float(score_inc);
  } else if (c.flags & kHighScoring) {
    score_inc = n_clear;
    reward = reward + 1000.0f * float(n_clear);
  } else {
    score_inc = n_clear;
    reward = reward + 100.0f * float(n_clear);
  }

  // death: a cell in row 0 after the clear
  bool death = false;
  if (locked)
    for (int w = 0; w < nw; ++w)
      death = death ||
              (uint32_t(after[at(c, nw, 0, w, b)]) & valid_word(c, w)) != 0u;
  const bool alive_lock = locked && !death;

  // holes (empty cells under a filled one: a prefix OR down each word) and
  // non-empty rows, at lock only
  const int old_holes = io.scal_in[sHoles][b];
  const int old_ph = io.scal_in[sPh][b];
  int holes = old_holes, ph = old_ph;
  if (locked) {
    holes = 0;
    for (int w = 0; w < nw; ++w) {
      const uint32_t valid = valid_word(c, w);
      uint32_t above = 0u;
      for (int y = 0; y < H; ++y) {
        const uint32_t r = uint32_t(after[at(c, nw, y, w, b)]);
        above |= r;
        holes += __popc(~r & above & valid);
      }
    }
    if (c.flags & (kPenHeight | kPenHeightInc)) {
      int nonempty = 0;
      for (int y = 0; y < H; ++y) {
        bool any = false;
        for (int w = 0; w < nw; ++w)
          any = any ||
                (uint32_t(after[at(c, nw, y, w, b)]) & valid_word(c, w)) != 0u;
        nonempty += any;
      }
      if (c.flags & kPenHeight) {
        if (alive_lock) reward = reward - float(nonempty);
      } else {
        const int inc = nonempty - old_ph;
        if (alive_lock && inc > 0) reward = reward - float(10 * inc);
        if (alive_lock) ph = nonempty;
      }
    }
    if (c.flags & kPenHoles) {
      if (alive_lock) reward = reward - float(5 * holes);
    } else if (c.flags & kPenHolesInc) {
      if (alive_lock) reward = reward - float(5 * (holes - old_holes));
    }
  }
  if (death) reward = -100.0f;   // death overwrites the whole step's reward

  // -- spawn from the precomputed draw, on an alive lock only ---------------
  int cnt[7], maxc = io.counts[b];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    cnt[i] = io.counts[size_t(i) * B + b];
    maxc = max(maxc, cnt[i]);
  }
  const int r = io.r_draw[b];
  int piece_new = 0, cum = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    cum += 5 + maxc - cnt[i];
    piece_new += cum < r;
  }
  const int piece_next = alive_lock ? piece_new : piece;
  const int rot_next = alive_lock ? 0 : rot1;
  const int ax_next = alive_lock ? c.spawn_x : ax1;
  const int ay_next = alive_lock ? 0 : ay2;
#pragma unroll
  for (int i = 0; i < 7; ++i)
    io.counts_out[size_t(i) * B + b] =
        cnt[i] + ((alive_lock && i == piece_new) ? 1 : 0);

  // -- emit: board | piece; the persistent board keeps board & ~piece -------
  Masks me;
  piece_masks<kOneWord>(piece_next, rot_next, ax_next, c, me);
  for (int y = 0; y < H; ++y) {
    for (int w = 0; w < nw; ++w) {
      const size_t i = at(c, nw, y, w, b);
      const uint32_t ra = uint32_t(after[i]);
      const uint32_t pe = piece_word(me, y, ay_next, w);
      io.emitted[i] = int32_t(ra | pe);
      io.rows_out[i] = int32_t(ra & ~pe);
    }
  }

  int32_t* so = io.scal_out;
  so[sPiece * B + b] = piece_next;
  so[sRot * B + b] = rot_next;
  so[sAx * B + b] = ax_next;
  so[sAy * B + b] = ay_next;
  so[sLock * B + b] = lock1;
  so[sTime * B + b] = io.scal_in[sTime][b] + 1;
  so[sScore * B + b] = io.scal_in[sScore][b] + (locked ? score_inc : 0);
  so[sHoles * B + b] = holes;
  so[sLines * B + b] = io.scal_in[sLines][b] + n_clear;
  so[sPh * B + b] = ph;
  so[sDeaths * B + b] = io.scal_in[sDeaths][b] + (death ? 1 : 0);
  io.reward[b] = reward;
  io.done[b] = death;
}

}  // namespace

// in_ptrs: rows, the 11 scalars of state.SCALAR_FIELDS, counts, action,
// r_draw (15 device pointers). out_ptrs: rows_out, scal_out [11, B],
// counts_out, emitted, reward, done (6). Rows are [H, NW, B] words. Returns
// cudaGetLastError() of the launch; launches nothing for B == 0.
extern "C" int tetris_step_launch(const void* const* in_ptrs,
                                  void* const* out_ptrs, int H, int NW, int B,
                                  int width, int lock_mod, int spawn_x,
                                  int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0) return 0;
  StepIO io;
  io.rows = static_cast<const int32_t*>(in_ptrs[0]);
  for (int i = 0; i < kNScalars; ++i)
    io.scal_in[i] = static_cast<const int32_t*>(in_ptrs[1 + i]);
  io.counts = static_cast<const int32_t*>(in_ptrs[12]);
  io.action = static_cast<const int32_t*>(in_ptrs[13]);
  io.r_draw = static_cast<const int32_t*>(in_ptrs[14]);
  io.rows_out = static_cast<int32_t*>(out_ptrs[0]);
  io.scal_out = static_cast<int32_t*>(out_ptrs[1]);
  io.counts_out = static_cast<int32_t*>(out_ptrs[2]);
  io.emitted = static_cast<int32_t*>(out_ptrs[3]);
  io.reward = static_cast<float*>(out_ptrs[4]);
  io.done = static_cast<bool*>(out_ptrs[5]);
  StepCfg c;
  c.H = H;
  c.NW = NW;
  c.B = B;
  c.width = width;
  c.lock_mod = lock_mod;
  c.spawn_x = spawn_x;
  c.flags = flags;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (NW == 1)
    step_kernel<true><<<blocks, threads, 0, st>>>(io, c);
  else
    step_kernel<false><<<blocks, threads, 0, st>>>(io, c);
  return int(cudaGetLastError());
}
