"""Seconds a job spends building its engine: the index over the db and
its upload to the card (`TorchEngine.__init__`, `index/kmer.py`,
`native/host.c`), the benchmark's own span ended by a synchronise; mean
per job."""


def read(ctx):
    return ctx.mean_span("index_build_s")
