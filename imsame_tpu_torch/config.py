"""Runtime configuration for the engine.

One dataclass mirroring the reference CLI flags and their defaults
(reference: src/IMSAME.c:44-49 and init_args at src/IMSAME.c:520-578), plus
the engine tunables that have no reference equivalent (batching).

Reference flag quirks honored here:
  * ``-igap``/``-egap`` are *negated* on parse (src/IMSAME.c:565,568): users
    pass positive penalties; the engine stores negative scores.  The
    dataclass stores the already-negative scores, like the reference's
    internal state, with defaults igap=-5, egap=-2.
  * ``--verbose`` is accepted but dead, as in the reference
    (src/IMSAME.c:32,524 -- VERBOSE_ACTIVE is never read).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    """Pipeline configuration (defaults == reference defaults)."""

    # Acceptance thresholds (reference: src/IMSAME.c:44-49).
    min_e_value: float = 1e-20
    min_coverage: float = 0.5
    min_identity: float = 0.5
    # Gap scores, stored negative (post-negation, reference internal form).
    igap: int = -5
    egap: int = -2

    # Reference thread count; kept for parity of the query-scan stream
    # boundary quirk (a thread's first read does not receive the previous
    # read's trailing base).  The engine emulates a given thread split; 1
    # gives the canonical deterministic stream.
    n_threads: int = 1

    # --- engine tunables (no reference equivalent) ---
    # Candidates gated per read in stage 1 (most reads accept their first
    # candidate, so a small first window resolves them cheaply); stage 2
    # flat-gates every remaining candidate of the unresolved tail.
    first_window: int = 8
    # Scale first_window with the dictionary's average bucket load
    # (n_entries / 4^k): dense databases push the true partner's seed
    # past a fixed-size window, sending whole true-pair streams to the
    # much larger stage-2 gate.  F_eff = F * max(1, ceil(2*load)), capped
    # at 64.  Accepts are F-invariant by construction.
    first_window_auto: bool = True
    # Flat-gate chunk sizes (candidates per device call), descending
    # choice by pipeline.TorchEngine._gate_spans; past SHORT_WINDOW capped
    # by pipeline.GATE_MAX_ELEMENTS (the CPU's plain gate's temporaries).
    gate_chunks: tuple = (1 << 21, 1 << 19, 1 << 16)
    # NW batch-shape ladders (descending; see pipeline._nw_chunks).  The
    # stats-only accept path has no bp tensor, so its ladder tops out
    # high; the render path materializes 4*(2L-1)*L bytes of
    # backpointers per pair (~0.5 MB at the 256 bucket).
    nw_stats_batches: tuple = (32768, 8192, 4096, 2048, 1024, 512, 256)
    nw_render_batches: tuple = (2048, 1024, 512, 256)
    # Device-memory budget for one render chunk's backpointer tensor; the
    # render ladder is capped per length bucket so B*8*L^2 stays under it.
    nw_render_bp_budget: int = 2 << 30
    # Length buckets (reads padded up to the smallest bucket >= their
    # len).  The CUDA kernels are instantiated for exactly these
    # (ops/nw_cuda.py LENGTHS); 3072 covers MAX_READ_SIZE.
    length_buckets: tuple = (128, 256, 512, 1024, 2048, 3072)
    # Device-side candidate enumeration (ops/enum_gate.py): the extension
    # gate rebuilds each read's candidate stream on the device from the
    # packed query rows and the engine-resident bucket table, so the host
    # builds and uploads no candidate arrays, only per-read rank windows.
    # Off by default, as in the JAX engine; PERF.md holds the H100's A/B
    # against the host-built gate.  Applies only with the packed index
    # format (one device), to queries whose row count, padded as the JAX
    # engine pads it (a power of two, at least 256), is at most
    # pipeline.ENUM_MAX_ROWS, and to compares of fewer than
    # pipeline.ENUM_MAX_CANDIDATES candidates.
    gate_enum: bool = False
    # Device mesh (n_data, n_dict) of one engine (parallel/mesh.py):
    # "auto" = every visible device of the engine's device type on the
    # data axis, halved until the batch shapes divide evenly (one device
    # if that leaves one, or if one is visible: "cuda:k" and the CPU are
    # one device); None = one device; (n_data, n_dict) = that grid, whose
    # batch shapes must divide (pipeline.TorchEngine._make_mesh).  The
    # dict axis shards the index payload by row range, the data axis the
    # gate chunks and NW batches.
    mesh_shape: object = "auto"

    def validate(self) -> None:
        if self.min_e_value < 0:
            raise ValueError("min_e_value must be >= 0")
        if not (0 < self.min_coverage):
            raise ValueError("min_coverage must be > 0")
        if not (0 < self.min_identity):
            raise ValueError("min_identity must be > 0")
        if self.n_threads < 1:
            raise ValueError("n_threads must be >= 1")
        if any(c % 32 for c in self.gate_chunks):
            raise ValueError("gate_chunks must be multiples of 32")
