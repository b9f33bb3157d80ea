"""Report rendering -- byte-identical to the reference's -out format.

Record format (reference: src/alignmentFunctions.c:163-171 accept+emit,
:210-274 build_alignment renderer; verified by executing the reference):

    (<qread>, <dbread>) : <id>% <cov>% <ylen>\\n $$$$$$$ \\n
    <60-col db line>\\n<60-col query line>\\n<match line>\\n ... \\n

Percentages are floor integer divisions clamped to 100, identities are
counted *during rendering* (a '*' per non-dash equal pair), and the block
loop runs while both right-aligned buffers still have characters -- all
reference quirks (SURVEY.md section 6.7, 6.9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..constants import ALIGN_LEN

_DASH = ord("-")
_NLB = ord("\n")
_STAR = ord("*")
_SPACE = ord(" ")


def render_alignment(
    rec_x: np.ndarray,
    rec_y: np.ndarray,
    head_x: int,
    head_y: int,
    maximum_len: int,
) -> Tuple[bytes, int]:
    """Faithful port of the 60-column block renderer
    (src/alignmentFunctions.c:230-271).  Returns (block_text, identities).
    The returned text includes the trailing blank line the reference appends
    before the NUL terminator."""
    out = bytearray()
    identities = 0
    i = head_x + 1
    j = head_y + 1
    while i <= maximum_len and j <= maximum_len:
        offset = 0
        before_i = i
        while offset < ALIGN_LEN and i <= maximum_len:
            out.append(rec_x[i])
            i += 1
            offset += 1
        out.append(_NLB)
        offset = 0
        before_j = j
        while offset < ALIGN_LEN and j <= maximum_len:
            out.append(rec_y[j])
            j += 1
            offset += 1
        out.append(_NLB)
        while before_i < i:
            cx = rec_x[before_i]
            cy = rec_y[before_j]
            if cx != _DASH and cy != _DASH and cx == cy:
                out.append(_STAR)
                identities += 1
            else:
                out.append(_SPACE)
            before_j += 1
            before_i += 1
        out.append(_NLB)
    out.append(_NLB)
    return bytes(out), identities


def format_record(
    qread: int,
    dbread: int,
    identities: int,
    length: int,
    ylen: int,
    block_text: bytes,
) -> bytes:
    """Accepted-pair record header + blocks
    (src/alignmentFunctions.c:167-168).  Integer percentages use uint64
    floor division, clamped with MIN(100, .)."""
    id_pct = min(100, (100 * identities) // length)
    cov_pct = min(100, (100 * length) // ylen)
    header = f"({qread}, {dbread}) : {id_pct}% {cov_pct}% {ylen}\n $$$$$$$ \n"
    return header.encode() + block_text


def format_summary(accepted: int, n_query: int, n_db: int, min_e: float, min_cov: float) -> str:
    """User-visible summary lines (values match src/IMSAME.c:471-472)."""
    jaccard = accepted / ((n_db + n_query) - accepted)
    lines = [
        f"[INFO] {accepted} reads ({n_query}) from the query were found in the "
        f"database ({n_db}) at a minimum e-value of {min_e:.6e} and minimum "
        f"coverage of {int(100 * min_cov)}%.",
        f"[INFO] The Jaccard-index is: {jaccard:.6e}",
    ]
    return "\n".join(lines)


def jaccard_index(accepted: int, n_query: int, n_db: int) -> float:
    return accepted / ((n_db + n_query) - accepted)
