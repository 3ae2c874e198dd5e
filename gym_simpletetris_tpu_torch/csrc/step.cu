// Engine transition kernel A of the PyTorch port, in three instances: a warp
// per env over a shared-memory tile of envs (boards up to 32 rows), a thread
// per env over its board staged in shared memory (taller boards, and large
// batches), and a thread per env on global memory (boards whose tile does
// not fit).
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
// in XLA. Here every instance serves every width.
//
// Board layout, as in the JAX state: rows [H, NW, B] words, global bit
// x + kXShift of a row in word (x + kXShift) >> 5; NW == 1 is the flat
// [H, B] of single-word boards. Every per-env input and output is a [B] row
// (scalars, the seven counts, action, draw, reward, done).
//
// A piece mask row holds at most 7 bits, at global bits s .. s + 6 with
// s = ax + 1, so it touches at most words s >> 5 and (s >> 5) + 1. A pose
// is held as that base word index and two words per relative row (Masks),
// the funnel shift of core/engine.py::piece_masks; a word at index >= NW
// does not exist and takes nothing. A bit outside [kXShift, kXShift +
// width) collides; each word's in-board bits come from the width
// (valid_word). At width 25 word 1 holds only guard bits: its valid bits
// are 0, so a row is full on word 0 alone.
//
// What bounds it on the H100. A step moves 4 * (3 * H * NW + 2 * 18 + 3)
// + 1 bytes per env: 397 at 10 x 20, 1.6 MB at B = 4096, half a
// microsecond of HBM time. Up to B = 4096 nothing near that is reached: the
// cost is the launch and the chain of dependent steps each env takes
// (candidate, profile, drops, lock, compaction, holes, spawn, emit). The
// bytes start to matter only from about B = 16384 (6.5 MB, 1.9 us). A
// thread per env on global memory runs one such chain per thread, 32
// blocks of 128 threads at B = 4096: a quarter of the SMs with one warp
// each, every board read a dependent global load (about 20 us whatever B),
// and lanes waiting on each other's loops.
//
// What the warp instance does about it:
// - A block takes a tile of E = 2^log_e neighbouring envs. Every load is
//   issued before any compute: cp.async copies each row word of the tile
//   (E neighbouring envs: one coalesced segment) and each per-env input into
//   shared memory, and one wait and one barrier follow. Each env's rows sit
//   at an odd stride (H * NW | 1 words) and its record at kRec (37) words,
//   so the transposed accesses of the staging and store loops, env e and
//   e + 1 in neighbouring lanes, fall in different banks.
// - Then one warp per env, one lane per board row: lane y holds row y (in
//   registers for NW = 1 and 2, read from the tile for wider rows). Lane a
//   decides whether the post-action pose collides at anchor a from rows
//   a - 3 .. a + 3 (seven shuffles), and one ballot gives the whole
//   collision profile as a bit mask; the hard drop is its first set bit
//   above the anchor, soft drop, gravity and the resting check are bit
//   tests. A single anchor (the move candidate; anchor 32 at H = 32) is one
//   more ballot over lanes 0-6, one relative row each. On lock: full rows by
//   ballot, stable compaction by a scatter (a kept row y moves down by the
//   full rows below it, __popc), death from row 0, holes by a prefix OR down
//   the lanes, non-empty rows by ballot, and the spawn by a max, a prefix
//   sum and a ballot over lanes 0-6 that hold the counts. Nothing diverges
//   within a warp: a lock is one env's, so the whole warp takes it.
// - The tile keeps only the piece-erased board and each env's next pose
//   (base word, anchor row, 14 mask words); the store loop writes rows_out
//   and emitted = rows_out | piece from them in coalesced segments, and the
//   per-env outputs likewise.
// A warp per env runs the env's whole control flow in every lane, so it
// issues many times the instructions of a thread per env and its time grows
// with B (1-2 us per 1000 envs on the H100): past B = 9000-16000, by the
// words a row, the staged thread instance is the faster one. That instance
// copies each env's board into its thread's column of a shared-memory tile
// first and loads the per-env inputs up front, so its chain waits on
// shared memory; its collision test is branch-free and its masks stay in
// registers. The launch plan (instance, E or threads, shared memory) is
// made in Python, ops/cuda_step.launch_plan, so the CPU tests hold it.
//
// What the TPU kernel needed and these do not (ops/pallas_step.py:24-31):
// the (piece, rot) mask lookup is a __constant__ table index, not a one-hot
// f32 matmul; a window row is a shuffle or a direct read, not a one-hot
// select; prefix OR and prefix sum are shuffles; popcount is __popc. Any B
// works: the tail tile is masked.
//
// All board words are uint32_t here. The rows arrive as int32 tensors that
// carry the uint32 bits, and masks reach bit 31, so no signed shift ever
// touches them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kNRows = 7;   // relative rows spanned by any piece
constexpr int kDyOff = 3;   // relative row k covers dy = k - kDyOff
constexpr int kXShift = 4;  // column x lives at bit x + kXShift
constexpr int kNScalars = 11;
constexpr int kWarpMaxH = 32;   // the warp instance: a lane per board row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;   // dynamic shared memory of a block (H100)
constexpr int kSmemStaged = 48 * 1024;   // the staged thread instance's tile
constexpr int kMaxDevices = 64;

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

// Per-env [B] rows of the inputs (StepIO::in) and outputs (StepIO::out),
// and the words of an env's record in the warp instance's tile: the inputs
// as staged, overwritten in place by the outputs, then the next pose.
enum {
  rCounts = kNScalars,           // 7 counts
  rAction = rCounts + 7,         // in: action; out: the reward's bits
  rDraw = rAction + 1,           // in: draw; out (record only): done
  rIO = rDraw + 1,               // [B] inputs per env
  rBase = rIO,                   // next pose: mask base word
  rAy = rBase + 1,               //            anchor row
  rLo = rAy + 1,                 //            in-board mask words in base
  rHi = rLo + kNRows,            //            and in base + 1
  kRec = rHi + kNRows + 1,       // record stride, odd: 37
};
static_assert(kRec % 2 == 1, "an odd record stride keeps envs in distinct banks");

struct StepIO {
  const int32_t* rows;          // [H, NW, B]
  const int32_t* in[rIO];       // 11 scalars, 7 count rows, action, draw
  int32_t* rows_out;            // [H, NW, B], piece-erased board
  int32_t* emitted;             // [H, NW, B], piece burned in
  int32_t* out[rIO - 1];        // 11 scalars, 7 count rows, reward (f32)
  bool* done;                   // [B]
};

struct StepCfg {
  int H, NW, B, width, lock_mod, spawn_x, flags;
};

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

// ----------------------------------------------- thread-per-env instances

// Global -> shared copies that do not pass through registers, so a thread
// issues all of its staging loads before it waits for any.
__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One env's board as its thread sees it: row y's word w at
// p[(y * nw + w) * ld]. Either the [H, NW, B] rows themselves (p at env b,
// ld = B) or the thread's column of a shared-memory tile (ld = threads).
template <class T>
struct Col {
  T* p;
  size_t ld;
  int nw;
  __device__ __forceinline__ T& operator()(int y, int w) const {
    return p[(size_t(y) * nw + w) * ld];
  }
};

// is_occupied of the reference for a whole piece at anchor row ay: a cell
// row with y < 0 is skipped before any x check; otherwise it collides if it
// has a cell outside the columns, any cell at y >= H, or a cell on the board.
// Branch-free, so the row reads of all seven relative rows are issued
// together (each predicated on its row being on the board).
__device__ __forceinline__ bool collides(const Col<const int32_t>& rows,
                                         const Masks& M, int ay,
                                         const StepCfg& c) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kNRows; ++k) {
    const int y = ay + k - kDyOff;
    const uint32_t lo = M.lo[k], hi = M.hi[k];
    const bool on = y >= 0 && (lo | hi) != 0u;
    const bool in = on && y < c.H;
    const uint32_t blo = in && lo != 0u ? uint32_t(rows(y, M.base)) : 0u;
    const uint32_t bhi = in && hi != 0u ? uint32_t(rows(y, M.base + 1)) : 0u;
    hit = hit || (on && (((lo & ~M.vlo) | (hi & ~M.vhi)) != 0u || !in)) ||
          ((blo & lo) | (bhi & hi)) != 0u;
  }
  return hit;
}

// The JAX engine's collision profile read at one index: False outside [0, H].
__device__ __forceinline__ bool profile_at(const Col<const int32_t>& rows,
                                           const Masks& M, int idx,
                                           const StepCfg& c) {
  return idx >= 0 && idx <= c.H && collides(rows, M, idx, c);
}

// v[k] for a k held at run time (0 outside [0, kNRows)), without indexing a
// register array dynamically.
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[kNRows], int k) {
  uint32_t r = 0u;
#pragma unroll
  for (int i = 0; i < kNRows; ++i) r = k == i ? v[i] : r;
  return r;
}

// Word w of the piece burned into board row y (in-board bits only); pick
// keeps the masks in registers.
__device__ __forceinline__ uint32_t piece_word(const Masks& M, int y, int ay,
                                               int w) {
  const int k = y - ay + kDyOff;
  if (w == M.base) return pick(M.lo, k) & M.vlo;
  if (w == M.base + 1) return pick(M.hi, k) & M.vhi;
  return 0u;
}

// One thread per env; kOneWord fixes NW = 1. kStaged: the thread first
// copies its board into its column of a shared-memory tile ([H * NW]
// [threads] words: neighbouring threads in neighbouring banks), every copy
// issued before any is waited for, and then reads and compacts it there;
// the chain of dependent reads each env walks (drops, compaction, death,
// holes, emit) then waits on shared memory, not on global loads. Otherwise
// it reads the rows in global memory (thread b reads rows[(y * NW + w) * B
// + b], a warp 32 neighbouring words), writes the locked board to rows_out
// and re-reads it: the instance for boards whose tile does not fit.
template <bool kOneWord, bool kStaged>
__global__ void step_thread_kernel(StepIO io, StepCfg c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= c.B) return;
  const int H = c.H;
  const int nw = kOneWord ? 1 : c.NW;
  // every per-env input up front, before the board is touched
  int in[rIO];
#pragma unroll
  for (int f = 0; f < rIO; ++f) in[f] = io.in[f][b];
  // rows: the board read; scratch: where the locked board is compacted (in
  // place in the tile: a row moves only down, to a row already read)
  Col<const int32_t> rows{io.rows + b, size_t(c.B), nw};
  Col<int32_t> scratch{io.rows_out + b, size_t(c.B), nw};
  if constexpr (kStaged) {
    extern __shared__ __align__(16) int32_t s_cols[];
    int32_t* col = s_cols + threadIdx.x;
    for (int j = 0; j < H * nw; ++j)
      copy_async4(col + size_t(j) * blockDim.x, io.rows + size_t(j) * c.B + b);
    copy_async_wait();
    rows = {col, blockDim.x, nw};
    scratch = {col, blockDim.x, nw};
  }

  const int piece = in[sPiece];
  const int rot = in[sRot];
  const int ax = in[sAx];
  const int ay = in[sAy];
  const int lock = in[sLock];
  const int action = in[rAction];
  Masks m;

  // -- action: the one candidate it asks for, at the current anchor row ----
  int ax1 = ax, rot1 = rot & 3;
  if (action == kLeft || action == kRight) {
    const int nx = ax + (action == kLeft ? -1 : 1);
    piece_masks<kOneWord>(piece, rot, nx, c, m);
    if (!collides(rows, m, ay, c)) ax1 = nx;
  } else if (action == kRotL || action == kRotR) {
    const int nr = (rot + (action == kRotL ? -1 : 1)) & 3;
    piece_masks<kOneWord>(piece, nr, ax, c, m);
    if (!collides(rows, m, ay, c)) rot1 = nr;
  }

  // -- drops against the post-action pose -------------------------------------
  Masks m1;
  piece_masks<kOneWord>(piece, rot1, ax1, c, m1);
  int ay1 = ay;
  if (action == kHard) {
    // first blocked profile row below the anchor; H + 1 when none blocks
    ay1 = H + 1;
    for (int y = max(ay + 1, 0); y <= H; ++y)
      if (collides(rows, m1, y, c)) { ay1 = y - 1; break; }
  } else if (action == kSoft && !profile_at(rows, m1, ay + 1, c)) {
    ay1 = ay + 1;
  }
  // gravity: one extra soft drop every step
  const int ay2 = ay1 + (profile_at(rows, m1, ay1 + 1, c) ? 0 : 1);
  const int lock0 = ((c.flags & kStepReset) && ay2 != ay1) ? 0 : lock;

  // -- lock-delay FSM --------------------------------------------------------
  const bool resting = profile_at(rows, m1, ay2 + 1, c);
  int lock1 = lock0;
  if (resting) {
    lock1 = (lock0 + 1) % c.lock_mod;
    if (lock1 < 0) lock1 += c.lock_mod;                 // floor modulo
  }
  const bool locked = resting && lock1 == 0;

  // -- lock: burn the piece and compact full rows, bottom up, stable ---------
  // rows_after lives in scratch when the piece locked, else it is the input.
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
        const uint32_t v = uint32_t(rows(y, w)) | piece_word(m1, y, ay2, w);
        full = full && (v & valid) == valid;
        scratch(wp, w) = int32_t(v);
      }
      if (full) ++n_clear;
      else --wp;
    }
    for (; wp >= 0; --wp)
      for (int w = 0; w < nw; ++w) scratch(wp, w) = 0;
  }
  const Col<const int32_t> after =
      locked ? Col<const int32_t>{scratch.p, scratch.ld, nw} : rows;

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
      death = death || (uint32_t(after(0, w)) & valid_word(c, w)) != 0u;
  const bool alive_lock = locked && !death;

  // holes (empty cells under a filled one: a prefix OR down each word) and
  // non-empty rows, at lock only
  const int old_holes = in[sHoles];
  const int old_ph = in[sPh];
  int holes = old_holes, ph = old_ph;
  if (locked) {
    holes = 0;
    for (int w = 0; w < nw; ++w) {
      const uint32_t valid = valid_word(c, w);
      uint32_t above = 0u;
      for (int y = 0; y < H; ++y) {
        const uint32_t r = uint32_t(after(y, w));
        above |= r;
        holes += __popc(~r & above & valid);
      }
    }
    if (c.flags & (kPenHeight | kPenHeightInc)) {
      int nonempty = 0;
      for (int y = 0; y < H; ++y) {
        bool any = false;
        for (int w = 0; w < nw; ++w)
          any = any || (uint32_t(after(y, w)) & valid_word(c, w)) != 0u;
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
  int cnt[7], maxc = in[rCounts];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    cnt[i] = in[rCounts + i];
    maxc = max(maxc, cnt[i]);
  }
  const int r = in[rDraw];
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
    io.out[rCounts + i][b] = cnt[i] + ((alive_lock && i == piece_new) ? 1 : 0);

  // -- emit: board | piece; the persistent board keeps board & ~piece -------
  Masks me;
  piece_masks<kOneWord>(piece_next, rot_next, ax_next, c, me);
  for (int y = 0; y < H; ++y) {
    for (int w = 0; w < nw; ++w) {
      const size_t i = (size_t(y) * nw + w) * c.B + b;
      const uint32_t ra = uint32_t(after(y, w));
      const uint32_t pe = piece_word(me, y, ay_next, w);
      io.emitted[i] = int32_t(ra | pe);
      io.rows_out[i] = int32_t(ra & ~pe);
    }
  }

  io.out[sPiece][b] = piece_next;
  io.out[sRot][b] = rot_next;
  io.out[sAx][b] = ax_next;
  io.out[sAy][b] = ay_next;
  io.out[sLock][b] = lock1;
  io.out[sTime][b] = in[sTime] + 1;
  io.out[sScore][b] = in[sScore] + (locked ? score_inc : 0);
  io.out[sHoles][b] = holes;
  io.out[sLines][b] = in[sLines] + n_clear;
  io.out[sPh][b] = ph;
  io.out[sDeaths][b] = in[sDeaths] + (death ? 1 : 0);
  reinterpret_cast<float*>(io.out[rAction])[b] = reward;
  io.done[b] = death;
}

// ------------------------------------------------------- warp instance

// A pose's masks and, per relative row k (bit k), whether it has a cell
// (nz) and whether one lies outside the columns (xo). The same in every
// lane of the warp.
struct Shape {
  Masks m;
  unsigned nz, xo;
};

template <bool kOneWord>
__device__ __forceinline__ void make_shape(int piece, int rot, int ax,
                                           const StepCfg& c, Shape& s) {
  piece_masks<kOneWord>(piece, rot, ax, c, s.m);
  s.nz = s.xo = 0u;
#pragma unroll
  for (int k = 0; k < kNRows; ++k) {
    const uint32_t lo = s.m.lo[k], hi = s.m.hi[k];
    s.nz |= unsigned((lo | hi) != 0u) << k;
    s.xo |= unsigned(((lo & ~s.m.vlo) | (hi & ~s.m.vhi)) != 0u) << k;
  }
}

// is_occupied of one relative row k at board row y, given that row's words
// `base` and base + 1 (lo, hi) and the mask words (mlo, mhi): skipped at
// y < 0, else a cell outside the columns, at y >= H or on the board.
__device__ __forceinline__ bool row_hits(const Shape& s, int k, int y, int H,
                                         uint32_t lo, uint32_t hi,
                                         uint32_t mlo, uint32_t mhi) {
  return y >= 0 && ((s.nz >> k) & 1u) != 0u &&
         (((s.xo >> k) & 1u) != 0u || y >= H || (lo & mlo) != 0u ||
          (hi & mhi) != 0u);
}

// One env's board as its warp sees it. kNW = 1, 2: lane y holds row y's
// words in r (0 for y >= H); kNW = 0: NW is c.NW and the words are read
// from the tile, row y's word w at brd[y * nw + w].
template <int kNW>
struct Board {
  uint32_t* brd;
  uint32_t r[kNW > 0 ? kNW : 1];
  int H, nw, lane;

  // Lane y's word w: its register, or the tile (0 for lanes y >= H).
  __device__ __forceinline__ uint32_t own(int w) const {
    if constexpr (kNW > 0) {
      uint32_t v = 0u;
#pragma unroll
      for (int i = 0; i < kNW; ++i) v = w == i ? r[i] : v;
      return v;
    } else {
      return lane < H ? brd[lane * nw + w] : 0u;
    }
  }

  // Words base and base + 1 of board row y, for a y that may differ from
  // lane to lane; junk where y is outside [0, H), which row_hits never
  // reads. kNW > 0 shuffles, so every lane of the warp must call it.
  __device__ __forceinline__ void pair(int base, int y, uint32_t& lo,
                                       uint32_t& hi) const {
    if constexpr (kNW > 0) {
      lo = __shfl_sync(kFull, own(base), y & 31);
      hi = kNW > 1 ? __shfl_sync(kFull, own(base + 1), y & 31) : 0u;
    } else {
      const bool in = y >= 0 && y < H;
      lo = in && base < nw ? brd[y * nw + base] : 0u;
      hi = in && base + 1 < nw ? brd[y * nw + base + 1] : 0u;
    }
  }
};

// Whether the pose collides at one anchor row: lane k < 7 takes relative
// row k, and a ballot joins them.
template <int kNW>
__device__ __forceinline__ bool collides_at(const Board<kNW>& bd,
                                            const Shape& s, int anchor) {
  const int k = bd.lane, y = anchor + k - kDyOff;
  uint32_t lo, hi;
  bd.pair(s.m.base, y, lo, hi);
  const bool hit = k < kNRows &&
                   row_hits(s, k, y, bd.H, lo, hi, pick(s.m.lo, k),
                            pick(s.m.hi, k));
  return __ballot_sync(kFull, hit) != 0u;
}

// The collision profile at anchors 0 .. H (bit a), the JAX engine's dense
// [H + 1] profile: lane a takes anchor a from rows a - 3 .. a + 3, and
// anchor 32 (at H = 32 only) is one more ballot.
//
// With the rows in registers the row terms fold: a cell at y >= H collides
// whatever the board, so anchor a collides at the bottom iff its lowest
// non-empty relative row kmax lands there (a + kmax - 3 >= H); a cell
// outside the columns collides iff its row is at y >= 0 (k >= 3 - a); and
// the rest is the overlap with rows a + k - 3 >= 0 (a shuffled row from
// past the board's last lane is junk only where the bottom term already
// holds).
template <int kNW>
__device__ __forceinline__ uint64_t collision_profile(const Board<kNW>& bd,
                                                      const Shape& s) {
  const int a = bd.lane;
  bool hit = false;
  if constexpr (kNW > 0) {
    const uint32_t wlo = bd.own(s.m.base), whi = bd.own(s.m.base + 1);
    uint32_t over = 0u;
#pragma unroll
    for (int k = 0; k < kNRows; ++k) {
      const int src = (a + k - kDyOff) & 31;
      uint32_t lo = __shfl_sync(kFull, wlo, src);
      uint32_t hi = kNW > 1 ? __shfl_sync(kFull, whi, src) : 0u;
      if (k < kDyOff && a + k < kDyOff) lo = hi = 0u;
      over |= (lo & s.m.lo[k]) | (hi & s.m.hi[k]);
    }
    const int kmax = 31 - __clz(s.nz | 1u);
    const int skip = a < kDyOff ? kDyOff - a : 0;   // relative rows at y < 0
    hit = over != 0u || (s.nz != 0u && a + kmax - kDyOff >= bd.H) ||
          (s.xo >> skip) != 0u;
  } else {
#pragma unroll
    for (int k = 0; k < kNRows; ++k) {
      const int y = a + k - kDyOff;
      uint32_t lo, hi;
      bd.pair(s.m.base, y, lo, hi);
      hit = hit || row_hits(s, k, y, bd.H, lo, hi, s.m.lo[k], s.m.hi[k]);
    }
  }
  uint64_t p = __ballot_sync(kFull, hit && a <= bd.H);
  if (bd.H == kWarpMaxH) p |= uint64_t(collides_at(bd, s, kWarpMaxH)) << 32;
  return p;
}

// One env's transition by its warp. rec: its record; brd: its rows in the
// tile, which hold the piece-erased board when it returns.
template <int kNW>
__device__ __forceinline__ void step_env(const StepCfg& c, int32_t* rec,
                                         uint32_t* brd, int lane) {
  constexpr bool kOneWord = kNW == 1;
  const int H = c.H;
  Board<kNW> bd;
  bd.brd = brd;
  bd.H = H;
  bd.nw = kNW > 0 ? kNW : c.NW;
  bd.lane = lane;
  const int nw = bd.nw;
  if constexpr (kNW > 0) {
#pragma unroll
    for (int w = 0; w < kNW; ++w) bd.r[w] = lane < H ? brd[lane * kNW + w] : 0u;
  }
  const int piece = rec[sPiece], rot = rec[sRot], ax = rec[sAx];
  const int ay = rec[sAy], lock = rec[sLock], action = rec[rAction];
  const int old_holes = rec[sHoles], old_ph = rec[sPh];
  const int time = rec[sTime], score = rec[sScore], lines = rec[sLines];
  const int deaths = rec[sDeaths], r_draw = rec[rDraw];
  const int cnt = lane < 7 ? rec[rCounts + lane] : INT_MIN;

  // -- action: the one candidate it asks for, at the current anchor row ----
  int ax1 = ax, rot1 = rot & 3;
  Shape s;
  bool have = false;   // s holds the post-action pose
  if (action == kLeft || action == kRight || action == kRotL ||
      action == kRotR) {
    const bool move = action == kLeft || action == kRight;
    const int nx = move ? ax + (action == kLeft ? -1 : 1) : ax;
    const int nr = move ? rot : (rot + (action == kRotL ? -1 : 1)) & 3;
    make_shape<kOneWord>(piece, nr, nx, c, s);
    if (!collides_at(bd, s, ay)) {
      ax1 = nx;
      rot1 = nr & 3;
      have = true;
    }
  }
  if (!have) make_shape<kOneWord>(piece, rot1, ax1, c, s);

  // -- drops against the post-action pose -------------------------------------
  const uint64_t prof = collision_profile(bd, s);
  auto blocked = [&](int idx) {
    return idx >= 0 && idx <= H && ((prof >> idx) & 1ull) != 0ull;
  };
  int ay1 = ay;
  if (action == kHard) {
    // first blocked anchor below the current one; H + 1 when none blocks
    const int from = ay + 1;
    const uint64_t below =
        from <= 0 ? prof : from > H ? 0ull : prof & (~0ull << from);
    ay1 = below ? __ffsll(static_cast<long long>(below)) - 2 : H + 1;
  } else if (action == kSoft && !blocked(ay + 1)) {
    ay1 = ay + 1;
  }
  // gravity: one extra soft drop every step
  const int ay2 = ay1 + (blocked(ay1 + 1) ? 0 : 1);
  const int lock0 = ((c.flags & kStepReset) && ay2 != ay1) ? 0 : lock;

  // -- lock-delay FSM --------------------------------------------------------
  const bool resting = blocked(ay2 + 1);
  int lock1 = lock0;
  if (resting) {
    lock1 = (lock0 + 1) % c.lock_mod;
    if (lock1 < 0) lock1 += c.lock_mod;                 // floor modulo
  }
  const bool locked = resting && lock1 == 0;

  // -- lock: burn, full rows, stable compaction in the tile -----------------
  int n_clear = 0, score_inc = 0, holes = old_holes, ph = old_ph;
  bool death = false;
  float reward = (c.flags & kRewardStep) ? 1.0f : 0.0f;
  if (locked) {
    const int kp = lane - ay2 + kDyOff;
    const bool on = lane < H && kp >= 0 && kp < kNRows;
    const uint32_t plo = on ? pick(s.m.lo, kp) & s.m.vlo : 0u;
    const uint32_t phi = on ? pick(s.m.hi, kp) & s.m.vhi : 0u;
    const int base = s.m.base;
    auto burned = [&](int w) {
      return bd.own(w) | (w == base ? plo : w == base + 1 ? phi : 0u);
    };
    bool full = lane < H;
    for (int w = 0; w < nw; ++w) {
      const uint32_t valid = valid_word(c, w);
      full = full && (burned(w) & valid) == valid;
    }
    const unsigned fullm = __ballot_sync(kFull, full);
    n_clear = __popc(fullm);
    // a kept row moves down by the full rows below it; the top n_clear
    // rows, which no kept row reaches, become empty
    const int dest = lane + __popc(lane < 31 ? fullm >> (lane + 1) : 0u);
    for (int w = 0; w < nw; ++w) {
      const uint32_t v = burned(w);
      __syncwarp();
      if (lane < H && !full) brd[dest * nw + w] = v;
      if (lane < n_clear) brd[lane * nw + w] = 0u;
      __syncwarp();
    }
    if constexpr (kNW > 0) {
#pragma unroll
      for (int w = 0; w < kNW; ++w)
        bd.r[w] = lane < H ? brd[lane * kNW + w] : 0u;
    }

    // scoring; with no lock, every table adds 0 to the reward
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
    bool row0 = false;
    for (int w = lane; w < nw; w += 32)
      row0 = row0 || (brd[w] & valid_word(c, w)) != 0u;
    death = __ballot_sync(kFull, row0) != 0u;
    const bool alive = !death;

    // holes: an empty cell under a filled one, by a prefix OR down the
    // lanes; non-empty rows by ballot
    unsigned hl = 0u;
    bool any = false;
    for (int w = 0; w < nw; ++w) {
      const uint32_t x = bd.own(w), valid = valid_word(c, w);
      uint32_t above = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, above, d);
        if (lane >= d) above |= t;
      }
      hl += __popc(~x & above & valid);
      any = any || (x & valid) != 0u;
    }
    holes = int(__reduce_add_sync(kFull, lane < H ? hl : 0u));
    const int nonempty = __popc(__ballot_sync(kFull, any));
    if (c.flags & kPenHeight) {
      if (alive) reward = reward - float(nonempty);
    } else if (c.flags & kPenHeightInc) {
      const int inc = nonempty - old_ph;
      if (alive && inc > 0) reward = reward - float(10 * inc);
      if (alive) ph = nonempty;
    }
    if (c.flags & kPenHoles) {
      if (alive) reward = reward - float(5 * holes);
    } else if (c.flags & kPenHolesInc) {
      if (alive) reward = reward - float(5 * (holes - old_holes));
    }
  }
  if (death) reward = -100.0f;   // death overwrites the whole step's reward
  const bool alive_lock = locked && !death;

  // -- spawn from the precomputed draw, on an alive lock only ---------------
  int piece_new = 0;
  if (alive_lock) {
    const int maxc = __reduce_max_sync(kFull, cnt);
    int cum = lane < 7 ? 5 + maxc - cnt : 0;
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int t = __shfl_up_sync(kFull, cum, d);
      if (lane >= d) cum += t;
    }
    piece_new = __popc(__ballot_sync(kFull, lane < 7 && cum < r_draw));
  }

  // -- emit: the tile keeps board & ~piece; the store adds the piece back ---
  // The record keeps the next pose's base word, anchor row and in-board
  // mask words; with no alive lock that pose is the post-action one, s.
  auto emit = [&](const Masks& me, int ay_next) {
    const int ke = lane - ay_next + kDyOff;
    const bool eon = lane < H && ke >= 0 && ke < kNRows;
    const uint32_t elo = eon ? pick(me.lo, ke) & me.vlo : 0u;
    const uint32_t ehi = eon ? pick(me.hi, ke) & me.vhi : 0u;
    __syncwarp();
    if (elo != 0u) brd[lane * nw + me.base] &= ~elo;
    if (ehi != 0u) brd[lane * nw + me.base + 1] &= ~ehi;
    if (lane == 0) {
      rec[rBase] = me.base;
      rec[rAy] = ay_next;
#pragma unroll
      for (int k = 0; k < kNRows; ++k) {
        rec[rLo + k] = int32_t(me.lo[k] & me.vlo);
        if (!kOneWord) rec[rHi + k] = int32_t(me.hi[k] & me.vhi);
      }
    }
  };
  if (alive_lock) {
    Masks me;
    piece_masks<kOneWord>(piece_new, 0, c.spawn_x, c, me);
    emit(me, 0);
  } else {
    emit(s.m, ay2);
  }
  if (lane < kNRows)
    rec[rCounts + lane] = cnt + ((alive_lock && lane == piece_new) ? 1 : 0);
  if (lane == 0) {
    rec[sPiece] = alive_lock ? piece_new : piece;
    rec[sRot] = alive_lock ? 0 : rot1;
    rec[sAx] = alive_lock ? c.spawn_x : ax1;
    rec[sAy] = alive_lock ? 0 : ay2;
    rec[sLock] = lock1;
    rec[sTime] = time + 1;
    rec[sScore] = score + score_inc;
    rec[sHoles] = holes;
    rec[sLines] = lines + n_clear;
    rec[sPh] = ph;
    rec[sDeaths] = deaths + (death ? 1 : 0);
    rec[rAction] = __float_as_int(reward);
    rec[rDraw] = death ? 1 : 0;
  }
}

// A block takes the tile of envs [blockIdx.x * E, + E), E = 2^log_e, with
// one warp per env (blockDim.x == 32 * E). Dynamic shared memory: the
// records [E][kRec], then the rows [E][H * NW | 1]. `io` stays in the
// parameter space (__grid_constant__), so a warp indexes its [B] rows by a
// field number held at run time without a local copy.
template <int kNW>
__global__ void __launch_bounds__(1024)
    step_warp_kernel(const __grid_constant__ StepIO io, StepCfg c,
                     int log_e) {
  extern __shared__ __align__(16) uint32_t s_tile[];
  const int E = 1 << log_e, B = c.B;
  const int nw = kNW > 0 ? kNW : c.NW;
  const int S = c.H * nw, stride = S | 1;
  int32_t* recs = reinterpret_cast<int32_t*>(s_tile);
  uint32_t* tile = s_tile + E * kRec;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x << log_e;

  // -- stage: every load issued before any compute ------------------------
  for (int i = tid; i < (S << log_e); i += nthr) {
    const int j = i >> log_e, e = i & (E - 1), b = b0 + e;
    if (b < B) copy_async4(tile + e * stride + j, io.rows + size_t(j) * B + b);
  }
  // the per-env inputs: warp w copies fields w, w + E, ..., lane e env e
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const bool env_lane = lane < E && b0 + lane < B;
  if (env_lane)
    for (int f = warp; f < rIO; f += nwarps)
      copy_async4(recs + lane * kRec + f, io.in[f] + b0 + lane);
  copy_async_wait();
  __syncthreads();

  // -- a warp per env --------------------------------------------------------
  for (int e = warp; e < E; e += nwarps)
    if (b0 + e < B) step_env<kNW>(c, recs + e * kRec, tile + e * stride, lane);
  __syncthreads();

  // -- stores: rows_out and emitted = rows_out | piece, then the per-env rows
  for (int i = tid; i < (S << log_e); i += nthr) {
    const int j = i >> log_e, e = i & (E - 1), b = b0 + e;
    if (b >= B) continue;
    const int32_t* rec = recs + e * kRec;
    const uint32_t v = tile[e * stride + j];
    const int y = j / nw, w = j - y * nw;
    const int k = y - rec[rAy] + kDyOff, base = rec[rBase];
    uint32_t pe = 0u;
    if (k >= 0 && k < kNRows)
      pe = w == base ? uint32_t(rec[rLo + k])
                     : w == base + 1 ? uint32_t(rec[rHi + k]) : 0u;
    const size_t gi = size_t(j) * B + b;
    io.rows_out[gi] = int32_t(v);
    io.emitted[gi] = int32_t(v | pe);
  }
  if (env_lane)
    for (int f = warp; f < rIO; f += nwarps) {
      const int32_t v = recs[lane * kRec + f];
      if (f < rIO - 1) io.out[f][b0 + lane] = v;
      else io.done[b0 + lane] = v != 0;
    }
}

// The launch's arguments, packed by ops/cuda_step.py (struct "<18Q14i").
// in: rows, the 11 scalars of state.SCALAR_FIELDS, counts [7, B], action,
// r_draw. boards: an int32 buffer holding rows_out and emitted (H * NW * B
// words each), then the counts [7, B]; small: one holding the 11 scalars
// [11, B], the reward (B float32) and done (B bools in (B + 3) / 4 words)
// (ops/cuda_step.out_sizes). Rows are [H, NW, B] words. The plan comes from
// ops/cuda_step.launch_plan: instance 1 is the warp per env (H <= 32;
// E = 2^log_e envs a block, threads = 32 * E, `smem` bytes of dynamic
// shared memory), instance 2 the thread per env over a staged tile
// (`threads` envs a block, `smem` >= 4 * threads * H * NW bytes, at most
// 48 KB), instance 0 the thread per env on global memory.
struct LaunchArgs {
  const void* in[15];
  void* boards;
  void* small;
  void* stream;
  int32_t H, NW, B, width, lock_mod, spawn_x, flags;
  int32_t instance, log_e, threads, blocks, smem, device, pad;
};
static_assert(sizeof(LaunchArgs) == 200, "the record ops/cuda_step.py packs");

}  // namespace

// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// plan the kernels cannot run; launches nothing for B == 0.
extern "C" int tetris_step_launch(const void* args) {
  const LaunchArgs& a = *static_cast<const LaunchArgs*>(args);
  const int H = a.H, NW = a.NW, B = a.B, log_e = a.log_e;
  const int threads = a.threads, blocks = a.blocks, smem = a.smem;
  const int device = a.device;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0) return 0;
  StepIO io;
  io.rows = static_cast<const int32_t*>(a.in[0]);
  for (int i = 0; i < kNScalars; ++i)
    io.in[i] = static_cast<const int32_t*>(a.in[1 + i]);
  const int32_t* counts = static_cast<const int32_t*>(a.in[12]);
  for (int i = 0; i < 7; ++i) io.in[rCounts + i] = counts + size_t(i) * B;
  io.in[rAction] = static_cast<const int32_t*>(a.in[13]);
  io.in[rDraw] = static_cast<const int32_t*>(a.in[14]);
  const size_t n = size_t(H) * NW * B;
  int32_t* o = static_cast<int32_t*>(a.boards);
  int32_t* sm = static_cast<int32_t*>(a.small);
  io.rows_out = o;
  io.emitted = o + n;
  for (int i = 0; i < kNScalars; ++i) io.out[i] = sm + size_t(i) * B;
  for (int i = 0; i < 7; ++i) io.out[rCounts + i] = o + 2 * n + size_t(i) * B;
  io.out[rAction] = sm + size_t(kNScalars) * B;
  io.done = reinterpret_cast<bool*>(sm + size_t(kNScalars + 1) * B);
  StepCfg c;
  c.H = H;
  c.NW = NW;
  c.B = B;
  c.width = a.width;
  c.lock_mod = a.lock_mod;
  c.spawn_x = a.spawn_x;
  c.flags = a.flags;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (a.instance == 1) {
    const long need =
        4L * (long(kRec) + ((long(H) * NW) | 1)) << (log_e < 0 ? 0 : log_e);
    if (H < 1 || H > kWarpMaxH || log_e < 0 || log_e > 5 ||
        threads != (32 << log_e) || smem < need || smem > kSmemMax ||
        long(blocks) << log_e < B)
      return int(cudaErrorInvalidValue);
    if (NW == 1) {
      step_warp_kernel<1><<<blocks, threads, smem, st>>>(io, c, log_e);
    } else if (NW == 2) {
      step_warp_kernel<2><<<blocks, threads, smem, st>>>(io, c, log_e);
    } else {
      // above 48 KB a block's dynamic shared memory must be allowed first;
      // raised once per device, so no launch in a CUDA graph capture asks
      static std::mutex mu;
      static int allowed[kMaxDevices];
      if (smem > 48 * 1024) {
        if (device < 0 || device >= kMaxDevices) return int(cudaErrorInvalidValue);
        std::lock_guard<std::mutex> hold(mu);
        if (allowed[device] < smem) {
          err = cudaFuncSetAttribute(
              step_warp_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
              kSmemMax);
          if (err != cudaSuccess) return int(err);
          allowed[device] = kSmemMax;
        }
      }
      step_warp_kernel<0><<<blocks, threads, smem, st>>>(io, c, log_e);
    }
  } else if (a.instance == 0 || a.instance == 2) {
    const bool staged = a.instance == 2;
    if (threads < 1 || threads > 1024 || long(blocks) * threads < B ||
        (staged && (smem < 4L * threads * H * NW || smem > kSmemStaged)))
      return int(cudaErrorInvalidValue);
    if (staged && NW == 1)
      step_thread_kernel<true, true><<<blocks, threads, smem, st>>>(io, c);
    else if (staged)
      step_thread_kernel<false, true><<<blocks, threads, smem, st>>>(io, c);
    else if (NW == 1)
      step_thread_kernel<true, false><<<blocks, threads, 0, st>>>(io, c);
    else
      step_thread_kernel<false, false><<<blocks, threads, 0, st>>>(io, c);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
