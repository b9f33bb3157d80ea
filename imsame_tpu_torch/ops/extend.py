"""E-value gate threshold, computed once per query read on the host.

The accept test ``K*qlen*dbtot*exp(-lambda*raw) < min_e`` (reference
src/alignmentFunctions.c:384 + :139) is equivalent to ``raw >= thr`` with
``thr`` an integer per read, so the device gate compares exact int32 raw
scores (ops/extend_packed.py) against this table.
"""

from __future__ import annotations

import numpy as np

from ..constants import QF_KARLIN, QF_LAMBDA


def raw_score_threshold(
    qlens: np.ndarray, db_total_len: int, min_e_value: float
) -> np.ndarray:
    """Per-read minimum integer raw score passing the e-value gate,
    bit-exact against the reference's long-double comparison.

    The reference computes
    ``e_value = (long double)QF_KARLIN * qlen * total_len * expl(-QF_LAMBDA*raw)``
    and gates with strict ``<`` (src/alignmentFunctions.c:384 + :139).  A
    float64 log-space estimate can land within rounding of an integer, so
    the estimate is corrected by evaluating the reference's exact
    expression in ``np.longdouble`` -- the same 80-bit x87 type and the
    same libm ``expl`` gcc compiles to on this platform -- at the two
    neighboring integers.  Returns int32 thresholds (int32 max = never
    passes)."""
    qlens = qlens.astype(np.float64)
    out = np.full(len(qlens), np.iinfo(np.int32).max, dtype=np.int64)
    if min_e_value > 0:
        with np.errstate(divide="ignore"):
            t = (
                np.log(QF_KARLIN * qlens * float(db_total_len))
                - np.log(min_e_value)
            ) / QF_LAMBDA
        # qlen == 0 -> t = -inf -> always passes (reference: 0 < min_e).
        thr = np.where(
            qlens > 0,
            np.floor(t) + 1.0,
            float(np.iinfo(np.int32).min),
        )
        out = np.clip(thr, np.iinfo(np.int32).min, np.iinfo(np.int32).max).astype(
            np.int64
        )
        # Long-double boundary correction, mirroring the reference's
        # operand order and promotions: C double literals promoted to
        # long double, left-associated products, expl.
        finite = (qlens > 0) & (out < np.iinfo(np.int32).max) & (
            out > np.iinfo(np.int32).min
        )
        if np.any(finite):
            lam = np.longdouble(np.float64(QF_LAMBDA))
            base = (
                np.longdouble(np.float64(QF_KARLIN))
                * qlens[finite].astype(np.longdouble)
                * np.longdouble(float(db_total_len))
            )
            e0 = np.longdouble(np.float64(min_e_value))
            sub = out[finite]

            def passes(raw):
                return base * np.exp(-lam * raw.astype(np.longdouble)) < e0

            # E is strictly decreasing in raw; the float64 estimate is
            # within 1 of the exact boundary.
            sub = np.where(passes(sub - 1), sub - 1, sub)
            sub = np.where(passes(sub), sub, sub + 1)
            out[finite] = sub
    return out.astype(np.int32)
