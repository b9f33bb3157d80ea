"""The control of the comparison (the reference with each read walking
only the first `judge.CONTROL_WINDOW` candidates of its stream, in the
program's place) comes out not correct, at a size a test run holds but
with streams of tens to hundreds of candidates a read
(`data/dense_mock.json`, `data/dense_long.json`);
`control.py` runs it on the card at the cells' own sizes."""

import numpy as np

from benchmark import control, run


def _files(traffic, config="dense_mock"):
    return dict(config=f"{run.BENCH}/tests/data/{config}.json",
                traffic=f"{run.BENCH}/traffic/{traffic}.json")


def test_control_fails_the_answers_where_reads_match():
    checks = control.control_checks(_files("pair"), 41, "cpu")
    assert checks["answers_wrong"][0] > checks["answers_wrong"][1], checks


def test_control_fails_the_counts_where_nothing_matches():
    checks = control.control_checks(_files("distant", "dense_long"), 43,
                                    "cpu")
    assert checks["candidates_off"][0] > checks["candidates_off"][1], checks
