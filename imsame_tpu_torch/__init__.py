"""imsame_tpu_torch -- all-vs-all metagenome read comparison on a CUDA GPU.

The PyTorch/CUDA port of the JAX package ``imsame_tpu``, which stays in the
repository as the reference the port is tested against.  It rebuilds the
capabilities of the reference C tool IMSAME (Bitlab-UMA/IMSAME): k-mer
dictionary seeding, ungapped extension + Karlin-Altschul e-value
filtering, a quirky semi-global gapped aligner, and per-read
identity/coverage reporting with sample-level Jaccard similarity.

Layout (mirrors imsame_tpu/):
  io/        FASTA ingest, report rendering (host, numpy)
  index/     flat sorted k-mer index
  native/    the host C runtime (host.c, a copy of imsame_tpu's) and its
             ctypes loader
  ops/       device compute: extension gate (torch), NW aligners and
             traceback (CUDA kernels in csrc/ + plain torch versions)
  csrc/      hand-written CUDA kernels for sm_90a (H100)
  pipeline   the engine (TorchEngine), on one device or a mesh
  parallel/  the device mesh and the sharded engine steps
  cli        reference-flag command line
  revcomp    the reference's reverse-complement tool
  orchestrator  all-vs-all sweep over a directory of samples
  distributed   gloo process group for the sweep's --distributed runs

This package imports torch and numpy, never jax or imsame_tpu.
"""

__version__ = "0.1.0"
