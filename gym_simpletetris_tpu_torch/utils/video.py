"""Episode video / GIF export through the observation raster (port of
``gym_simpletetris_tpu.utils.video``).

The reference repo showcases a GIF (README.md:6) but has no export code.
This renders episodes with the same pixel-exact raster as
``render('rgb_array')`` (160 px) or any size, raster kernel B on the card,
and writes GIFs with PIL (imported only by ``write_gif``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import env as api_env
from ..core.config import EnvConfig


def frames_from_rows(cfg: EnvConfig, rows_history, size: int = 160,
                     env_index: int = 0) -> np.ndarray:
    """Packed-rows history (a sequence of int32 tensors or uint32 / int32
    arrays [H, B] or [H, NW, B]) -> uint8[T, size, size, 3] of env
    ``env_index``. Env ``env_index``'s rows of every frame are stacked into
    one batch, so the raster is one launch for the whole history."""
    def word_rows(rows):
        if not isinstance(rows, torch.Tensor):
            a = np.ascontiguousarray(rows)
            rows = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                    else a.astype(np.int32))
        return rows[..., env_index]
    rows = torch.stack([word_rows(r) for r in rows_history], dim=-1)
    img = api_env.rasterize_rows(cfg, rows.contiguous(), size).cpu().numpy()
    return np.repeat(img[..., None], 3, axis=3)


def write_gif(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """uint8[T, H, W, 3] -> animated GIF (fps defaults to the reference's
    render cap, tetris_env.py:339). Requires PIL."""
    from PIL import Image
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def record_episode(env, policy=None, max_steps: int = 500, size: int = 160,
                   seed: int = 0) -> np.ndarray:
    """Roll one episode of a ``TetrisVectorEnv`` (batch 1+, on its device)
    from ``seed`` (the stream of ``jax.random.PRNGKey(seed)``) and return
    frames of env 0. ``policy(obs, t) -> actions`` defaults to random
    actions from ``np.random.RandomState(seed)``, as in the JAX package."""
    obs, state = env.reset(seed)
    rng = np.random.RandomState(seed)
    rows_history = [env.render_rows(state)]
    for t in range(max_steps):
        if policy is None:
            a = rng.randint(0, 7, env.batch_size)
        else:
            a = policy(obs, t)
        obs, state, reward, done, info = env.step(state, a)
        rows_history.append(env.render_rows(state))
        if bool(done[0]):
            break
    return frames_from_rows(env.config, rows_history, size=size)
