"""Host-side reconstruction of the report buffers from a traceback chain.

Mirrors the reference backtracker's emission exactly
(src/alignmentFunctions.c:493-560, see oracle/nw.py:backtrack_faithful) but
is driven by the chain of visited cells recorded on-device by
ops/traceback.py, so accepted pairs can be rendered without re-running the
DP on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


_DASH = ord("-")
_SPACE = ord(" ")


def backtrack_from_chain(
    chain: np.ndarray,  # [n_steps+1] packed px*4096+py, chain[0] = best cell
    n_steps: int,
    xlen: int,
    ylen: int,
    x_chars: np.ndarray,  # uint8 ASCII of the db read
    y_chars: np.ndarray,  # uint8 ASCII of the query read
) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Returns (rec_x, rec_y, head_x, head_y, maximum_len)."""
    PACK = 4096
    maximum_len = 2 * max(xlen, ylen)
    buf_len = 2 * maximum_len + 2
    rec_x = np.full(buf_len, _SPACE, dtype=np.uint8)
    rec_y = np.full(buf_len, _SPACE, dtype=np.uint8)
    head_x = maximum_len
    head_y = maximum_len

    bc_x, bc_y = int(chain[0]) // PACK, int(chain[0]) % PACK
    prev_x, prev_y = bc_x, bc_y

    for k in range(xlen - 1, bc_x, -1):
        rec_x[head_x] = _DASH
        head_x -= 1
    for k in range(ylen - 1, bc_y, -1):
        rec_y[head_y] = _DASH
        head_y -= 1

    RUN_FLAG = 1 << 26
    curr_x, curr_y = bc_x, bc_y
    for step in range(1, n_steps + 1):
        entry = int(chain[step])
        is_run = bool(entry & RUN_FLAG)
        entry &= RUN_FLAG - 1
        curr_x, curr_y = entry // PACK, entry % PACK
        if is_run:
            # diagonal-run jump: expand char-by-char, exactly the diag
            # branch repeated (prev - curr) times
            for k in range(prev_x - curr_x):
                rec_x[head_x] = x_chars[prev_x - k]
                head_x -= 1
                rec_y[head_y] = y_chars[prev_y - k]
                head_y -= 1
        elif curr_x == prev_x - 1 and curr_y == prev_y - 1:
            rec_x[head_x] = x_chars[prev_x]
            head_x -= 1
            rec_y[head_y] = y_chars[prev_y]
            head_y -= 1
        elif (prev_x - curr_x) > (prev_y - curr_y):
            for k in range(prev_x, curr_x, -1):
                rec_y[head_y] = _DASH
                head_y -= 1
                rec_x[head_x] = x_chars[k]
                head_x -= 1
        else:
            for k in range(prev_y, curr_y, -1):
                rec_x[head_x] = _DASH
                head_x -= 1
                rec_y[head_y] = y_chars[k]
                head_y -= 1
        prev_x, prev_y = curr_x, curr_y

    huecos_x = 0
    huecos_y = 0
    for k in range(curr_x - 1, -1, -1):
        rec_x[head_x] = _DASH
        head_x -= 1
        huecos_x += 1
    for k in range(curr_y - 1, -1, -1):
        rec_y[head_y] = _DASH
        head_y -= 1
        huecos_y += 1
    if huecos_x >= huecos_y:
        while huecos_x > 0:
            rec_y[head_y] = _SPACE
            head_y -= 1
            huecos_x -= 1
    else:
        while huecos_y > 0:
            rec_x[head_x] = _SPACE
            head_x -= 1
            huecos_y -= 1

    return rec_x, rec_y, head_x, head_y, maximum_len
