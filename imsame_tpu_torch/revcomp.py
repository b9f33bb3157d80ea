"""Standalone reverse-complement tool -- the reference's second binary
(src/reverseComplement.c): ``python -m imsame_tpu_torch.revcomp in.fa out.fa``.

Output matches the C tool byte-for-byte: reads emitted in *reverse file
order*, each sequence complemented (A<->T, C<->G, U->A, case preserved,
other letters passed through), reversed, on a single line
(src/reverseComplement.c:56-112).  Host-only: no device is touched.
"""

from __future__ import annotations

import sys

from .io.fasta import revcomp_fasta


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 2:
        sys.stderr.write(
            "USE: python -m imsame_tpu_torch.revcomp <in.fasta> <out.fasta>\n"
        )
        return 1
    revcomp_fasta(args[0], args[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
