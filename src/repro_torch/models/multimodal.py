"""Modality frontends: stubs, as in the JAX package.

The port of ``repro.models.multimodal``.  The ``[audio]`` and ``[vlm]``
architectures specify the transformer backbone only; the mel-spectrogram /
conv feature extractor (whisper) and the vision tower + projector (llava)
are out of scope.  The stubs produce *embedding-shaped* stand-ins: the
``fake_*`` functions draw deterministic numpy arrays from
``np.random.default_rng(seed)``, bit for bit the reference's, so the
backbone runs end to end on the same inputs in both packages.

llava-next "anyres" tiling is modelled as ``tiles x patches_per_tile``
tokens: the backbone sees a flat image-token prefix.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fake_audio_frames", "fake_image_patches", "WHISPER_FRAMES",
           "LLAVA_TILES", "LLAVA_PATCHES_PER_TILE", "llava_image_tokens"]

# whisper: 30 s of audio -> 3000 mel frames -> conv stride 2 -> 1500 positions
WHISPER_FRAMES = 1500

# llava-next anyres: base tile + up to 4 sub-tiles, 24x24=576 patches each
LLAVA_TILES = 2            # kept small: 1 base + 1 sub-tile by default
LLAVA_PATCHES_PER_TILE = 576


def llava_image_tokens(tiles: int = LLAVA_TILES) -> int:
    return tiles * LLAVA_PATCHES_PER_TILE


def fake_audio_frames(batch: int, d_model: int, frames: int = WHISPER_FRAMES,
                      seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, frames, d_model)).astype(np.float32) * 0.02


def fake_image_patches(batch: int, d_model: int, tokens: int | None = None,
                       seed: int = 0) -> np.ndarray:
    tokens = tokens or llava_image_tokens()
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, tokens, d_model)).astype(np.float32) * 0.02
