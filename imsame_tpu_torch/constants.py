"""Compile-time constants of the engine.

These mirror the reference's implicit config system (reference:
src/structs.h:11-22 and src/alignmentFunctions.h:1-2) so that results are
bit-compatible.  They are module-level constants here because they define
*behavioral* parity (k-mer size, scoring points, report width); runtime
tunables live in :mod:`imsame_tpu_torch.config`.
"""

# Seed (k-mer) length.  reference: src/structs.h:15 (FIXED_K)
FIXED_K = 12

# Match/mismatch score magnitude used by both the ungapped extension and the
# gapped aligner.  reference: src/structs.h:13 (POINT)
POINT = 4

# Maximum read length accepted by the gapped aligner.  reference:
# src/structs.h:19 (MAX_READ_SIZE); exceeding it is a hard error
# (src/alignmentFunctions.c:155).
MAX_READ_SIZE = 3000

# Report line width for the 60-column alignment blocks.  reference:
# src/structs.h:18 (ALIGN_LEN)
ALIGN_LEN = 60

# Karlin-Altschul parameters for the seed-filter e-value.  reference:
# src/alignmentFunctions.h:1-2 (QF_LAMBDA, QF_KARLIN)
QF_LAMBDA = 0.275
QF_KARLIN = 0.333

# Number of distinct k-mer keys: 4**FIXED_K.
N_KMER_KEYS = 4 ** FIXED_K

# Byte codes for the 2-bit nucleotide encoding (A=0, C=1, G=2, T=3), matching
# the reference's char_converter table (src/IMSAME.c:55-59).
CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3

# Sentinel for "no candidate" entries in padded hit tables.
NO_HIT = -1
