"""ANSI truecolor terminal preview — the headless-host analog of the
reference's live GLFW window (ray.cpp:1094-1143).  Each text row shows
two pixel rows via the upper-half-block glyph with independent
foreground (top pixel) and background (bottom pixel) colors, so a
24-bit-capable terminal displays the frame inline after every REPL
command."""

from __future__ import annotations

import sys

import numpy as np

_HALF = "▀"  # upper half block


def frame_to_ansi(img: np.ndarray, max_cols: int = 100) -> str:
    """(H, W, 3) float [0,1] or uint8 -> ANSI art string."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    H, W = img.shape[:2]
    step = max(1, -(-W // max_cols))
    img = img[::step, ::step]
    if img.shape[0] % 2:
        img = img[:-1]
    top = img[0::2]
    bot = img[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            parts.append(
                f"\x1b[38;2;{r1};{g1};{b1}m\x1b[48;2;{r2};{g2};{b2}m{_HALF}"
            )
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def print_frame(img: np.ndarray, file=None, max_cols: int = 100) -> None:
    print(frame_to_ansi(img, max_cols), file=file or sys.stdout)
