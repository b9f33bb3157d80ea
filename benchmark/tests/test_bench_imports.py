"""No module that the harness, a job kind, a metric or the reference
loads has jax, jaxlib, flax or imsame_tpu as its whole top-level name, and
the reference loads nothing of imsame_tpu_torch."""

import json
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "imsame_tpu"}


def _loaded(code: str) -> set:
    prog = ("import sys; sys.path.insert(0, %r)\n" % run.ROOT + code +
            "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    names = _loaded("from benchmark.reference import judge, dense, semantics")
    assert not names & FORBIDDEN
    assert "imsame_tpu_torch" not in names


def test_harness_job_kinds_and_metrics_load_no_jax():
    names = _loaded(
        "import glob, os\n"
        "from benchmark import run, control\n"
        "from benchmark.harness import trace, peaks\n"
        "for d in ('jobs', 'metrics', 'gen'):\n"
        "    for p in sorted(glob.glob(os.path.join(run.BENCH, d, '*.py'))):\n"
        "        run.load_module(p)\n"
        "import numpy as np\n"
        "data = run.load_module(os.path.join(run.BENCH, 'gen', 'mock.py'))"
        ".generate(dict(reads=50, read_len=150), dict(match_frac=0.5), "
        "np.random.default_rng(1))\n"
        "cfg = run.load_json(os.path.join(run.BENCH, 'configs', "
        "'mock100k.json'))\n"
        "job = run.load_module(os.path.join(run.BENCH, 'jobs', 'pair.py'))"
        ".Job(cfg, data, 'cpu')\n"
        "job.run()\n")
    assert "imsame_tpu_torch" in names
    assert not names & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("imsame_tpu_torch_like", sys)
    try:
        assert "imsame_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["imsame_tpu_torch_like"]
