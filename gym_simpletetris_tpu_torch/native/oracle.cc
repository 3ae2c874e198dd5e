// Native (C++) SimpleTetris engine: a host-side, single-env implementation of
// the exact reference semantics (/root/reference/gym_simpletetris/envs/
// tetris_env.py:125-335), written from the SURVEY.md §2.2 specification.
//
// Purpose in this framework:
//   1. Mass parity fuzzing. The Python reference steps at ~25k steps/s; this
//      engine steps at millions/s, so the JAX/TPU engine can be fuzzed against
//      a semantically independent oracle over orders of magnitude more
//      (config, action, horizon) space (tests/test_native_oracle.py). It is
//      itself cross-validated step-by-step against the in-place-loaded Python
//      reference before being trusted.
//   2. Fast host CPU fallback env (api/native_env.py) for users without an
//      accelerator.
//
// Independence note: this file deliberately mirrors the *reference's* per-cell
// formulation (mutable offset lists, per-cell collision loops, row-scan line
// clears) rather than the JAX engine's bit-packed compare-reduce formulation
// (core/engine.py), so the two implementations cannot share a bug.
//
// RNG: the reference's only draw is random.randint(1, sum(m)) at piece spawn
// (tetris_env.py:187). Parity is defined over an injected draw stream
// (SURVEY.md §7.3); every entry point below accepts an injected r (<=0 means
// "draw internally" from a splitmix64 stream) and reports the r it consumed so
// the same stream can be replayed into the JAX engine.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Piece tables in shape_names order (tetris_env.py:10-19): T J L Z S I O.
// 4 anchor-relative (dx, dy) cells; dy < 0 is above the anchor (row 0 = top).
const int BASE[7][4][2] = {
    {{0, 0}, {-1, 0}, {1, 0}, {0, -1}},    // T
    {{0, 0}, {-1, 0}, {0, -1}, {0, -2}},   // J
    {{0, 0}, {1, 0}, {0, -1}, {0, -2}},    // L
    {{0, 0}, {-1, 0}, {0, -1}, {1, -1}},   // Z
    {{0, 0}, {-1, -1}, {0, -1}, {1, 0}},   // S
    {{0, 0}, {0, -1}, {0, -2}, {0, -3}},   // I
    {{0, 0}, {0, -1}, {-1, 0}, {-1, -1}},  // O
};

const int NES_SCORES[5] = {0, 40, 100, 300, 1200};  // tetris_env.py:267

struct Shape {
  int c[4][2];
};

// rotated(shape, cclk) (tetris_env.py:22-26): cclk=true (rotate_right) maps
// (i,j)->(-j,i); cclk=false (rotate_left) maps (i,j)->(j,-i).
Shape rotated(const Shape& s, bool cclk) {
  Shape out;
  for (int k = 0; k < 4; ++k) {
    int i = s.c[k][0], j = s.c[k][1];
    if (cclk) {
      out.c[k][0] = -j;
      out.c[k][1] = i;
    } else {
      out.c[k][0] = j;
      out.c[k][1] = -i;
    }
  }
  return out;
}

bool shape_eq(const Shape& a, const Shape& b) {
  return std::memcmp(a.c, b.c, sizeof(a.c)) == 0;
}

uint64_t splitmix64(uint64_t* st) {
  uint64_t z = (*st += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

struct Game {
  int width, height;
  int lock_delay;
  bool step_reset;
  bool reward_step, pen_height, pen_height_inc, advanced, high_scoring;
  bool pen_holes, pen_holes_inc;

  // board[x * height + y], x-major like the reference's board[x, y]
  // (tetris_env.py:140); y = 0 is the top.
  std::vector<uint8_t> board;

  Shape shape;
  int piece_id;  // index into shape_names order
  int ax, ay;    // anchor (int; equivalent to the reference's float w/2 spawn,
                 // see core/config.py::spawn_x docstring)

  int time_, score, holes, lines_cleared, piece_height, n_deaths, lock_cnt;
  int shape_counts[7];
  uint64_t rng;

  uint8_t& at(int x, int y) { return board[x * height + y]; }
  uint8_t get(int x, int y) const { return board[x * height + y]; }

  // is_occupied (tetris_env.py:29-36): cells with y < 0 skip ALL checks
  // (including x bounds) — the above-board straddle quirk.
  bool occupied(const Shape& s, int x0, int y0) const {
    for (int k = 0; k < 4; ++k) {
      int x = x0 + s.c[k][0], y = y0 + s.c[k][1];
      if (y < 0) continue;
      if (x < 0 || x >= width || y >= height || get(x, y)) return true;
    }
    return false;
  }

  // _set_piece (tetris_env.py:323-327): per-cell bounds check, silently
  // dropping out-of-board cells; writes 1/0.
  void set_piece(bool on) {
    for (int k = 0; k < 4; ++k) {
      int x = ax + shape.c[k][0], y = ay + shape.c[k][1];
      if (x >= 0 && x < width && y >= 0 && y < height) at(x, y) = on ? 1 : 0;
    }
  }

  // _choose_shape (tetris_env.py:183-191): weights m[i] = 5 + max - count,
  // r = randint(1, sum(m)), linear walk. r_in <= 0 draws internally.
  // *r_used reports the draw consumed.
  int choose_shape(int r_in, int* r_used) {
    int maxc = shape_counts[0];
    for (int i = 1; i < 7; ++i)
      if (shape_counts[i] > maxc) maxc = shape_counts[i];
    int m[7], sum = 0;
    for (int i = 0; i < 7; ++i) {
      m[i] = 5 + maxc - shape_counts[i];
      sum += m[i];
    }
    int r = r_in > 0 ? r_in : (int)(1 + splitmix64(&rng) % (uint64_t)sum);
    *r_used = r;
    for (int i = 0; i < 7; ++i) {
      r -= m[i];
      if (r <= 0) return i;
    }
    return 6;  // unreachable for r in [1, sum]
  }

  // _new_piece (tetris_env.py:193-200)
  void new_piece(int r_in, int* r_used) {
    ax = width / 2;
    ay = 0;
    piece_id = choose_shape(r_in, r_used);
    shape_counts[piece_id] += 1;
    for (int k = 0; k < 4; ++k) {
      shape.c[k][0] = BASE[piece_id][k][0];
      shape.c[k][1] = BASE[piece_id][k][1];
    }
  }

  // _clear_lines (tetris_env.py:205-216): full-row scan + stable downward
  // compaction via a bottom-up row copy.
  int clear_lines() {
    int n = 0;
    std::vector<uint8_t> nb(board.size(), 0);
    int j = height - 1;
    for (int i = height - 1; i >= 0; --i) {
      bool full = true;
      for (int x = 0; x < width; ++x)
        if (!get(x, i)) {
          full = false;
          break;
        }
      if (full) {
        ++n;
      } else {
        for (int x = 0; x < width; ++x) nb[x * height + j] = get(x, i);
        --j;
      }
    }
    board.swap(nb);
    lines_cleared += n;
    return n;
  }

  // _count_holes (tetris_env.py:218-220): empty cells with any filled cell
  // above in the same column.
  int count_holes() {
    int h = 0;
    for (int x = 0; x < width; ++x) {
      bool seen = false;
      for (int y = 0; y < height; ++y) {
        if (get(x, y))
          seen = true;
        else if (seen)
          ++h;
      }
    }
    holes = h;
    return h;
  }

  // sum(np.any(board, axis=0)) (tetris_env.py:287): # of nonempty rows.
  int nonempty_rows() const {
    int n = 0;
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x)
        if (get(x, y)) {
          ++n;
          break;
        }
    return n;
  }

  // TetrisEngine.step (tetris_env.py:243-304). r_in/r_used as in choose_shape.
  void step(int action, int r_in, int* r_used, double* reward_out,
            int* done_out) {
    *r_used = 0;
    // action (value_action_map :152-160): 0=left 1=right 2=hard 3=soft
    // 4=rotl 5=rotr 6=idle; failed moves keep (shape, anchor).
    switch (action) {
      case 0:
        if (!occupied(shape, ax - 1, ay)) ax -= 1;
        break;
      case 1:
        if (!occupied(shape, ax + 1, ay)) ax += 1;
        break;
      case 2:  // hard_drop: iterate soft_drop to fixpoint (:54-59)
        while (!occupied(shape, ax, ay + 1)) ay += 1;
        break;
      case 3:
        if (!occupied(shape, ax, ay + 1)) ay += 1;
        break;
      case 4: {
        Shape ns = rotated(shape, /*cclk=*/false);
        if (!occupied(ns, ax, ay)) shape = ns;
        break;
      }
      case 5: {
        Shape ns = rotated(shape, /*cclk=*/true);
        if (!occupied(ns, ax, ay)) shape = ns;
        break;
      }
      default:
        break;  // idle
    }
    // gravity: one extra soft drop every step (:247-250)
    if (!occupied(shape, ax, ay + 1)) {
      ay += 1;
      if (step_reset) lock_cnt = 0;
    }

    time_ += 1;
    double reward = reward_step ? 1.0 : 0.0;
    bool done = false;

    // lock-delay FSM (:259-262): counter wraps modulo lock_delay+1; the piece
    // locks when it wraps to 0 while resting.
    if (occupied(shape, ax, ay + 1)) {  // _has_dropped (:202-203)
      lock_cnt = (lock_cnt + 1) % (std::max(lock_delay, 0) + 1);
      if (lock_cnt == 0) {
        set_piece(true);
        int cleared = clear_lines();
        if (advanced) {  // :266-269
          reward += 2.5 * NES_SCORES[cleared];
          score += NES_SCORES[cleared];
        } else if (high_scoring) {  // :270-272
          reward += 1000.0 * cleared;
          score += cleared;
        } else {  // :273-275
          reward += 100.0 * cleared;
          score += cleared;
        }
        // death = any cell in the top row after clearing (:277); reward is
        // OVERWRITTEN to -100 (:281) and no new piece spawns (:283-299).
        bool dead = false;
        for (int x = 0; x < width; ++x)
          if (get(x, 0)) {
            dead = true;
            break;
          }
        if (dead) {
          count_holes();
          n_deaths += 1;
          done = true;
          reward = -100.0;
        } else {
          int old_holes = holes;
          count_holes();
          if (pen_height) {  // :286-287
            reward -= nonempty_rows();
          } else if (pen_height_inc) {  // :288-292
            int nh = nonempty_rows();
            if (nh > piece_height) reward -= 10.0 * (nh - piece_height);
            piece_height = nh;
          }
          if (pen_holes) {  // :294-295
            reward -= 5.0 * holes;
          } else if (pen_holes_inc) {  // :296-297
            reward -= 5.0 * (holes - old_holes);
          }
          new_piece(r_in, r_used);
        }
      }
    }
    *reward_out = reward;
    *done_out = done ? 1 : 0;
  }

  // end-of-step emit (:301-303): burn piece, copy, erase — including the
  // death-erase and spawn-overlap-erase quirks (the final set_piece(false)
  // zeroes whatever cells the current piece covers).
  void emit(uint8_t* out) {
    set_piece(true);
    if (out) std::memcpy(out, board.data(), board.size());
    set_piece(false);
  }

  // TetrisEngine.clear (:306-315): per-episode counters reset; lock counter,
  // n_deaths and shape_counts deliberately carry over. Emits the zeroed
  // board WITHOUT the freshly spawned piece.
  void clear(int r_in, int* r_used) {
    time_ = 0;
    score = 0;
    holes = 0;
    lines_cleared = 0;
    piece_height = 0;
    new_piece(r_in, r_used);
    std::fill(board.begin(), board.end(), 0);
  }

  // valid_action_count (:222-230): actions whose primitive changes
  // (shape, anchor); idle never counts, rotations count iff unobstructed
  // (a rotated offset list never list-equals the original), soft and hard
  // each count iff one drop is possible.
  int valid_action_count() const {
    int n = 0;
    if (!occupied(shape, ax - 1, ay)) ++n;
    if (!occupied(shape, ax + 1, ay)) ++n;
    bool can_drop = !occupied(shape, ax, ay + 1);
    if (can_drop) n += 2;  // soft_drop and hard_drop both move
    Shape rl = rotated(shape, false), rr = rotated(shape, true);
    if (!occupied(rl, ax, ay) && !shape_eq(rl, shape)) ++n;
    if (!occupied(rr, ax, ay) && !shape_eq(rr, shape)) ++n;
    return n;
  }
};

}  // namespace

extern "C" {

void* tetris_new(int width, int height, int lock_delay, int step_reset,
                 int reward_step, int pen_height, int pen_height_inc,
                 int advanced, int high_scoring, int pen_holes,
                 int pen_holes_inc, uint64_t seed) {
  Game* g = new Game();
  g->width = width;
  g->height = height;
  g->lock_delay = lock_delay;
  g->step_reset = step_reset != 0;
  g->reward_step = reward_step != 0;
  g->pen_height = pen_height != 0;
  g->pen_height_inc = pen_height_inc != 0;
  g->advanced = advanced != 0;
  g->high_scoring = high_scoring != 0;
  g->pen_holes = pen_holes != 0;
  g->pen_holes_inc = pen_holes_inc != 0;
  g->board.assign((size_t)width * height, 0);
  g->ax = g->ay = 0;
  g->piece_id = 0;
  g->shape = Shape{};
  // __init__ counter values (tetris_env.py:164-181)
  g->time_ = -1;
  g->score = -1;
  g->holes = 0;
  g->lines_cleared = 0;
  g->piece_height = 0;
  g->n_deaths = 0;
  g->lock_cnt = 0;
  std::memset(g->shape_counts, 0, sizeof(g->shape_counts));
  g->rng = seed;
  return g;
}

void tetris_free(void* h) { delete (Game*)h; }

int tetris_clear(void* h, int r_in, uint8_t* out_board) {
  Game* g = (Game*)h;
  int r_used = 0;
  g->clear(r_in, &r_used);
  if (out_board) std::memcpy(out_board, g->board.data(), g->board.size());
  return r_used;
}

int tetris_step(void* h, int action, int r_in, uint8_t* out_board,
                double* out_reward, int* out_done) {
  Game* g = (Game*)h;
  int r_used = 0;
  g->step(action, r_in, &r_used, out_reward, out_done);
  g->emit(out_board);
  return r_used;
}

void tetris_render(void* h, uint8_t* out_board) { ((Game*)h)->emit(out_board); }

// Persistent (piece-erased) board, like reading engine.board between steps.
void tetris_board(void* h, uint8_t* out_board) {
  Game* g = (Game*)h;
  std::memcpy(out_board, g->board.data(), g->board.size());
}

// Piece/FSM state: ax, ay, piece_id, lock counter; shape8 = 4 (dx, dy) pairs.
void tetris_piece_state(void* h, int32_t* out4, int32_t* shape8) {
  Game* g = (Game*)h;
  out4[0] = g->ax;
  out4[1] = g->ay;
  out4[2] = g->piece_id;
  out4[3] = g->lock_cnt;
  for (int k = 0; k < 4; ++k) {
    shape8[2 * k] = g->shape.c[k][0];
    shape8[2 * k + 1] = g->shape.c[k][1];
  }
}

int tetris_valid_action_count(void* h) {
  return ((Game*)h)->valid_action_count();
}

void tetris_info(void* h, int32_t* out6, int32_t* counts7) {
  Game* g = (Game*)h;
  out6[0] = g->time_;
  out6[1] = g->piece_id;
  out6[2] = g->score;
  out6[3] = g->lines_cleared;
  out6[4] = g->holes;
  out6[5] = g->n_deaths;
  for (int i = 0; i < 7; ++i) counts7[i] = g->shape_counts[i];
}

// Fast fuzz/rollout driver: T steps with the internal RNG; when a step ends
// the episode and auto_clear is set, clear() runs before the next step
// (consuming one more draw). Per step t it records the emitted board (the
// reference's returned state copy), reward, done, and the draws consumed by
// the step (out_r_step[t], 0 if no spawn) and by the auto-clear
// (out_r_clear[t], 0 if none) — exactly the streams a parity harness must
// replay into the JAX engine.
void tetris_drive(void* h, const int32_t* actions, int t_steps, int auto_clear,
                  uint8_t* out_boards, float* out_rewards, uint8_t* out_dones,
                  int32_t* out_r_step, int32_t* out_r_clear) {
  Game* g = (Game*)h;
  size_t cells = g->board.size();
  for (int t = 0; t < t_steps; ++t) {
    double reward = 0.0;
    int done = 0, r_used = 0;
    g->step((int)actions[t], /*r_in=*/0, &r_used, &reward, &done);
    g->emit(out_boards ? out_boards + (size_t)t * cells : nullptr);
    if (out_rewards) out_rewards[t] = (float)reward;
    if (out_dones) out_dones[t] = (uint8_t)done;
    if (out_r_step) out_r_step[t] = r_used;
    int r_clear = 0;
    if (done && auto_clear) g->clear(/*r_in=*/0, &r_clear);
    if (out_r_clear) out_r_clear[t] = r_clear;
  }
}

// Step n live games (one per handle) by one action each, in one call —
// the hot path of the batched host vector env (api/native_env.py). If
// auto_clear, games that end are clear()ed after emitting (out_r_clear
// records the spawn draw). Threaded when `threads` > 1 and n is large
// enough to amortize thread launch.
// out_boards is laid out with ONE stride (game 0's board size); returns -1
// without stepping if any handle's board size differs (mixed-geometry
// batches would silently corrupt the buffer), else 0.
int tetris_step_vec(const uint64_t* handles, int n, const int32_t* actions,
                    int auto_clear, int threads, uint8_t* out_boards,
                    float* out_rewards, uint8_t* out_dones,
                    int32_t* out_r_step, int32_t* out_r_clear) {
  const size_t cells = n ? ((Game*)(uintptr_t)handles[0])->board.size() : 0;
  for (int i = 1; i < n; ++i)
    if (((Game*)(uintptr_t)handles[i])->board.size() != cells) return -1;
  auto run_range = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Game* g = (Game*)(uintptr_t)handles[i];
      double reward = 0.0;
      int done = 0, r_used = 0;
      g->step((int)actions[i], 0, &r_used, &reward, &done);
      g->emit(out_boards + (size_t)i * cells);
      out_rewards[i] = (float)reward;
      out_dones[i] = (uint8_t)done;
      if (out_r_step) out_r_step[i] = r_used;
      int r_clear = 0;
      if (done && auto_clear) g->clear(0, &r_clear);
      if (out_r_clear) out_r_clear[i] = r_clear;
    }
  };
  threads = std::max(1, std::min(threads, n / 64));  // >=64 games per thread
  if (threads <= 1) {
    run_range(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  int per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo < hi) pool.emplace_back(run_range, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// Batched clear: reset every handle (recording spawn draws). Same uniform
// board-size contract as tetris_step_vec: returns -1 on mixed geometries.
int tetris_clear_vec(const uint64_t* handles, int n, int32_t* out_r,
                     uint8_t* out_boards) {
  const size_t cells = n ? ((Game*)(uintptr_t)handles[0])->board.size() : 0;
  for (int i = 1; i < n; ++i)
    if (((Game*)(uintptr_t)handles[i])->board.size() != cells) return -1;
  for (int i = 0; i < n; ++i) {
    Game* g = (Game*)(uintptr_t)handles[i];
    int r = 0;
    g->clear(0, &r);
    out_r[i] = r;
    if (out_boards)
      std::memcpy(out_boards + (size_t)i * cells, g->board.data(), cells);
  }
  return 0;
}

// Batched host raster, sparse formulation: start every image from the
// all-empty base, then fill only OCCUPIED cells' pixel rectangles with the
// piece shade (cell blocks never overlap the border, so the filled value is
// the constant piece shade). ~80 occupied cells x block^2 byte-writes per
// image instead of a 7056-pixel gather — measured ~20x faster. rects is
// int32[cells, 4] = (row0, col0, block_h, block_w) per cell in the caller's
// cell order (precomputed from ops/raster.build_raster_maps).
// channels: 1 (grayscale) or 3 (rgb; base must be channel-tripled) — the
// channel axis is innermost, so block fills stay contiguous memsets.
void tetris_raster_vec(const uint8_t* boards, int n, int cells,
                       const uint8_t* base, const int32_t* rects, int size,
                       int channels, int piece_shade, int threads,
                       uint8_t* out) {
  const size_t nbytes = (size_t)size * size * channels;
  const int row = size * channels;
  auto run_range = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      const uint8_t* b = boards + (size_t)i * cells;
      uint8_t* o = out + (size_t)i * nbytes;
      std::memcpy(o, base, nbytes);
      for (int c = 0; c < cells; ++c) {
        if (!b[c]) continue;
        const int32_t* r = rects + 4 * c;
        for (int dy = 0; dy < r[2]; ++dy)
          std::memset(o + (size_t)(r[0] + dy) * row + r[1] * channels,
                      piece_shade, r[3] * channels);
      }
    }
  };
  threads = std::max(1, std::min(threads, n / 64));
  if (threads <= 1) {
    run_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo < hi) pool.emplace_back(run_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Batched get_info: one FFI call for the whole handle array (the per-step
// info path of the host vector env; a Python-side loop of tetris_info calls
// measured as the dominant per-step cost).
void tetris_info_vec(const uint64_t* handles, int n, int32_t* out6,
                     int32_t* counts7) {
  for (int i = 0; i < n; ++i)
    tetris_info((void*)(uintptr_t)handles[i], out6 + (size_t)i * 6,
                counts7 + (size_t)i * 7);
}

// Checkpoint/resume: the full game state as a flat buffer —
// 3-int header (width, height, packed flags incl. lock_delay) + 25 int32
// (shape cells, anchor, piece, counters, shape_counts) + 2 uint32 (rng) +
// W*H board bytes. Bit-identical resume (tests/test_native_oracle.py). Load
// verifies size (-1) AND the header against the target engine's geometry and
// reward/FSM flags (-2) — a snapshot only resumes into an identically
// configured engine.
int tetris_state_size(void* h) {
  return (int)(30 * 4 + ((Game*)h)->board.size());
}

static int32_t pack_flags(const Game* g) {
  return (g->lock_delay << 9) | (g->step_reset << 8) | (g->reward_step << 7) |
         (g->pen_height << 6) | (g->pen_height_inc << 5) | (g->advanced << 4) |
         (g->high_scoring << 3) | (g->pen_holes << 2) | (g->pen_holes_inc << 1);
}

void tetris_save(void* h, uint8_t* buf) {
  Game* g = (Game*)h;
  int32_t hdr[3] = {g->width, g->height, pack_flags(g)};
  std::memcpy(buf, hdr, sizeof(hdr));
  buf += sizeof(hdr);
  int32_t ints[25];
  int k = 0;
  for (int c = 0; c < 4; ++c) {
    ints[k++] = g->shape.c[c][0];
    ints[k++] = g->shape.c[c][1];
  }
  ints[k++] = g->ax;
  ints[k++] = g->ay;
  ints[k++] = g->piece_id;
  ints[k++] = g->time_;
  ints[k++] = g->score;
  ints[k++] = g->holes;
  ints[k++] = g->lines_cleared;
  ints[k++] = g->piece_height;
  ints[k++] = g->n_deaths;
  ints[k++] = g->lock_cnt;
  for (int i = 0; i < 7; ++i) ints[k++] = g->shape_counts[i];
  std::memcpy(buf, ints, sizeof(ints));
  std::memcpy(buf + sizeof(ints), &g->rng, 8);
  std::memcpy(buf + sizeof(ints) + 8, g->board.data(), g->board.size());
}

int tetris_load(void* h, const uint8_t* buf, int size) {
  Game* g = (Game*)h;
  if (size != tetris_state_size(h)) return -1;
  int32_t hdr[3];
  std::memcpy(hdr, buf, sizeof(hdr));
  if (hdr[0] != g->width || hdr[1] != g->height || hdr[2] != pack_flags(g))
    return -2;
  buf += sizeof(hdr);
  int32_t ints[25];
  std::memcpy(ints, buf, sizeof(ints));
  int k = 0;
  for (int c = 0; c < 4; ++c) {
    g->shape.c[c][0] = ints[k++];
    g->shape.c[c][1] = ints[k++];
  }
  g->ax = ints[k++];
  g->ay = ints[k++];
  g->piece_id = ints[k++];
  g->time_ = ints[k++];
  g->score = ints[k++];
  g->holes = ints[k++];
  g->lines_cleared = ints[k++];
  g->piece_height = ints[k++];
  g->n_deaths = ints[k++];
  g->lock_cnt = ints[k++];
  for (int i = 0; i < 7; ++i) g->shape_counts[i] = ints[k++];
  std::memcpy(&g->rng, buf + sizeof(ints), 8);
  std::memcpy(g->board.data(), buf + sizeof(ints) + 8, g->board.size());
  return 0;
}

// Parallel fuzz-stream generator: n independent games, each cleared once
// (recording the spawn draw in out_r0) and driven t_steps with auto-clear,
// fanned out over `threads` OS threads. cfg11 = the 11 tetris_new int args
// (width..penalise_holes_increase); all outputs are game-major (boards
// [n, T, W*H]; any output pointer may be null except out_r0).
void tetris_drive_many(const int32_t* cfg11, const uint64_t* seeds, int n,
                       const int32_t* actions, int t_steps, int threads,
                       int32_t* out_r0, uint8_t* out_boards,
                       float* out_rewards, uint8_t* out_dones,
                       int32_t* out_r_step, int32_t* out_r_clear,
                       int32_t* out_deaths, int32_t* out_counts) {
  const size_t cells = (size_t)cfg11[0] * cfg11[1];
  auto run_range = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      void* h = tetris_new(cfg11[0], cfg11[1], cfg11[2], cfg11[3], cfg11[4],
                           cfg11[5], cfg11[6], cfg11[7], cfg11[8], cfg11[9],
                           cfg11[10], seeds[i]);
      out_r0[i] = tetris_clear(h, 0, nullptr);
      const size_t o = (size_t)i * t_steps;
      tetris_drive(h, actions + o, t_steps, /*auto_clear=*/1,
                   out_boards ? out_boards + o * cells : nullptr,
                   out_rewards ? out_rewards + o : nullptr,
                   out_dones ? out_dones + o : nullptr,
                   out_r_step ? out_r_step + o : nullptr,
                   out_r_clear ? out_r_clear + o : nullptr);
      if (out_deaths || out_counts) {
        int32_t info6[6], counts7[7];
        tetris_info(h, info6, counts7);
        if (out_deaths) out_deaths[i] = info6[5];
        if (out_counts) std::memcpy(out_counts + (size_t)i * 7, counts7,
                                    sizeof(counts7));
      }
      tetris_free(h);
    }
  };
  threads = std::max(1, std::min(threads, n));
  if (threads == 1) {
    run_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo < hi) pool.emplace_back(run_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
