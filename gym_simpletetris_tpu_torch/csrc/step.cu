// Engine transition kernel of the PyTorch port: one thread per env.
//
// Replaces the Pallas TPU kernel gym_simpletetris_tpu/ops/pallas_step.py
// (_build_kernel, entered through engine_step_pallas). It computes what
// gym_simpletetris_tpu/core/engine.py::engine_step computes, for single-word
// boards (width <= 24): the four in-place move candidates and their
// collisions, the action, soft drop / hard drop / gravity against the
// post-action pose, the lock-delay FSM, burn, stable line compaction,
// scoring (NES / high / plain), death with the -100 overwrite, holes and the
// height penalties at lock, the count-balanced spawn from a precomputed draw,
// and the emitted board beside the piece-erased persistent board.
//
// What bounds it on the H100: nothing but memory and launch latency. A step
// moves about 4 * (3H + 2 * 11 + 2 * 7 + 4) bytes per env (read the board,
// write the board and the emitted board, the per-env scalars and counts) and
// does a few hundred integer operations per env. At B = 4096 and H = 20 that
// is under 2 MB, well under a microsecond of HBM time, so one launch of a few
// microseconds is the cost. The design answers it by doing the whole
// transition in one launch with no intermediate tensors: the state is read
// once, each output written once, and everything between lives in registers.
// The batch-minor layout ([H, B] words) makes thread b's row read rows[y*B+b],
// so a warp reads 32 neighbouring words.
//
// What the TPU kernel needed and this one does not (ops/pallas_step.py:24-31):
// the (piece, rot) mask lookup is a __constant__ table index, not a one-hot
// f32 matmul; a window row is a direct read, not a one-hot select; prefix OR
// and prefix sum are running loops; popcount is __popc; hard drop is a loop
// over the collision profile; line compaction walks a write pointer up from
// the bottom. Any B works: the tail block is masked.
//
// All board words are uint32_t here. The rows arrive as int32 tensors that
// carry the uint32 bits, and masks reach bit 31 at width 24, so no signed
// shift ever touches them.

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
  const int32_t* rows;                  // [H, B]
  const int32_t* scal_in[kNScalars];    // each [B]
  const int32_t* counts;                // [7, B]
  const int32_t* action;                // [B]
  const int32_t* r_draw;                // [B]
  int32_t* rows_out;                    // [H, B], piece-erased board
  int32_t* scal_out;                    // [11, B]
  int32_t* counts_out;                  // [7, B]
  int32_t* emitted;                     // [H, B], piece burned in
  float* reward;                        // [B]
  bool* done;                           // [B]
};

struct StepCfg {
  int H, B, lock_mod, spawn_x, flags;
  uint32_t valid;                       // in-board column bits
};

// Board-row masks of (piece, rot) at anchor column ax. An index outside the
// table gives an empty piece, as the JAX one-hot lookup does.
__device__ __forceinline__ void piece_masks(int piece, int rot, int ax,
                                            uint32_t m[kNRows]) {
  const int pr = piece * 4 + (rot & 3);
  const int s = ax + (kXShift - 3);
  const bool ok = pr >= 0 && pr < 28 && s >= 0 && s < 32;
  const int prc = ok ? pr : 0;
#pragma unroll
  for (int k = 0; k < kNRows; ++k)
    m[k] = ok ? (uint32_t(c_rowmasks[prc][k]) << s) : 0u;
}

__device__ __forceinline__ uint32_t row_at(const int32_t* rows, int y,
                                           const StepCfg& c, int b) {
  return (y >= 0 && y < c.H) ? uint32_t(rows[size_t(y) * c.B + b]) : 0u;
}

// is_occupied of the reference for a whole piece at anchor row ay: a cell
// row with y < 0 is skipped before any x check; otherwise it collides if it
// has a cell outside the columns, any cell at y >= H, or a cell on the board.
__device__ bool collides(const int32_t* rows, const uint32_t m[kNRows],
                         int ay, const StepCfg& c, int b) {
#pragma unroll
  for (int k = 0; k < kNRows; ++k) {
    const int y = ay + k - kDyOff;
    const uint32_t mk = m[k];
    if (y < 0 || mk == 0u) continue;
    if ((mk & ~c.valid) != 0u || y >= c.H) return true;
    if ((row_at(rows, y, c, b) & mk) != 0u) return true;
  }
  return false;
}

// The JAX engine's collision profile read at one index: False outside [0, H].
__device__ __forceinline__ bool profile_at(const int32_t* rows,
                                           const uint32_t m[kNRows], int idx,
                                           const StepCfg& c, int b) {
  return idx >= 0 && idx <= c.H && collides(rows, m, idx, c, b);
}

__device__ __forceinline__ uint32_t piece_row(const uint32_t m[kNRows], int y,
                                              int ay, uint32_t valid) {
  const int k = y - ay + kDyOff;
  return (k >= 0 && k < kNRows) ? (m[k] & valid) : 0u;
}

__global__ void step_kernel(StepIO io, StepCfg c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= c.B) return;
  const int H = c.H, B = c.B;
  const uint32_t valid = c.valid;

  const int piece = io.scal_in[sPiece][b];
  const int rot = io.scal_in[sRot][b];
  const int ax = io.scal_in[sAx][b];
  const int ay = io.scal_in[sAy][b];
  const int lock = io.scal_in[sLock][b];
  const int action = io.action[b];
  uint32_t m[kNRows];

  // -- action: the one candidate it asks for, at the current anchor row ----
  int ax1 = ax, rot1 = rot & 3;
  if (action == kLeft || action == kRight) {
    const int nx = ax + (action == kLeft ? -1 : 1);
    piece_masks(piece, rot, nx, m);
    if (!collides(io.rows, m, ay, c, b)) ax1 = nx;
  } else if (action == kRotL || action == kRotR) {
    const int nr = (rot + (action == kRotL ? -1 : 1)) & 3;
    piece_masks(piece, nr, ax, m);
    if (!collides(io.rows, m, ay, c, b)) rot1 = nr;
  }

  // -- drops against the post-action pose -------------------------------------
  uint32_t m1[kNRows];
  piece_masks(piece, rot1, ax1, m1);
  int ay1 = ay;
  if (action == kHard) {
    // first blocked profile row below the anchor; profile[H] always blocks
    ay1 = H + 1;
    for (int y = max(ay + 1, 0); y <= H; ++y)
      if (collides(io.rows, m1, y, c, b)) { ay1 = y - 1; break; }
  } else if (action == kSoft && !profile_at(io.rows, m1, ay + 1, c, b)) {
    ay1 = ay + 1;
  }
  // gravity: one extra soft drop every step
  const int ay2 = ay1 + (profile_at(io.rows, m1, ay1 + 1, c, b) ? 0 : 1);
  const int lock0 = ((c.flags & kStepReset) && ay2 != ay1) ? 0 : lock;

  // -- lock-delay FSM --------------------------------------------------------
  const bool resting = profile_at(io.rows, m1, ay2 + 1, c, b);
  int lock1 = lock0;
  if (resting) {
    lock1 = (lock0 + 1) % c.lock_mod;
    if (lock1 < 0) lock1 += c.lock_mod;                 // floor modulo
  }
  const bool locked = resting && lock1 == 0;

  // -- lock: burn the piece and compact full rows, bottom up, stable ---------
  // rows_after lives in rows_out when the piece locked, else it is the input.
  int n_clear = 0;
  if (locked) {
    int w = H - 1;
    for (int y = H - 1; y >= 0; --y) {
      const uint32_t v = uint32_t(io.rows[size_t(y) * B + b]) |
                         piece_row(m1, y, ay2, valid);
      if ((v & valid) == valid) ++n_clear;
      else io.rows_out[size_t(w--) * B + b] = int32_t(v);
    }
    for (; w >= 0; --w) io.rows_out[size_t(w) * B + b] = 0;
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

  const bool death = locked && (uint32_t(after[b]) & valid) != 0u;
  const bool alive_lock = locked && !death;

  // holes (empty cells under a filled one) and non-empty rows, at lock only
  const int old_holes = io.scal_in[sHoles][b];
  const int old_ph = io.scal_in[sPh][b];
  int holes = old_holes, ph = old_ph;
  if (locked) {
    uint32_t above = 0u;
    int nonempty = 0;
    holes = 0;
    for (int y = 0; y < H; ++y) {
      const uint32_t r = uint32_t(after[size_t(y) * B + b]);
      above |= r;
      holes += __popc(~r & above & valid);
      nonempty += (r & valid) != 0u;
    }
    if (c.flags & kPenHeight) {
      if (alive_lock) reward = reward - float(nonempty);
    } else if (c.flags & kPenHeightInc) {
      const int inc = nonempty - old_ph;
      if (alive_lock && inc > 0) reward = reward - float(10 * inc);
      if (alive_lock) ph = nonempty;
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
  uint32_t me[kNRows];
  piece_masks(piece_next, rot_next, ax_next, me);
  for (int y = 0; y < H; ++y) {
    const size_t i = size_t(y) * B + b;
    const uint32_t ra = uint32_t(after[i]);
    const uint32_t pe = piece_row(me, y, ay_next, valid);
    io.emitted[i] = int32_t(ra | pe);
    io.rows_out[i] = int32_t(ra & ~pe);
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
// counts_out, emitted, reward, done (6). Returns cudaGetLastError() of the
// launch; launches nothing for B == 0.
extern "C" int tetris_step_launch(const void* const* in_ptrs,
                                  void* const* out_ptrs, int H, int B,
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
  c.B = B;
  c.lock_mod = lock_mod;
  c.spawn_x = spawn_x;
  c.flags = flags;
  c.valid = ((1u << width) - 1u) << kXShift;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(io, c);
  return int(cudaGetLastError());
}
