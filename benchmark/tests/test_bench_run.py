"""The harness end to end on the CPU at a tiny size (rehearsals: never a
device metric), the runs that must give no result, the planted faults
that the check must fail, and, on the card, the control.

A rehearsal overrides the cell's configuration and mix with tiny sizes
(`TINY`); the limits are the cell's own."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import faults, harness, manifest

ROOT = manifest.ROOT
TINY_MNIST = {"data": {"n_train": 1200, "n_test": 200}, "partner_weights": [1, 2, 3, 4]}
TINY = {
    "mnist_cnn-p10.retrain": {"config": TINY_MNIST, "traffic": {
        "coalitions": [[2, 3], [4]], "per_request": 3, "sample": 3}},
    # four epochs: at this size one epoch of RMSprop(1e-4) leaves the model
    # near its initial accuracy, and a frozen step would read as training
    "cifar10_cnn-p5.sweep": {"config": {"data": {"n_train": 1500}, "held_out_test_rows": 200,
                                        "partner_weights": [1, 2, 3], "epoch_count": 4},
                             "traffic": {"sample": 3}},
    "mnist_cnn-p10.recon": {"config": TINY_MNIST, "traffic": {"sample": 4}},
}


def _run(args, cwd=ROOT, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_every_cell_has_a_rehearsal():
    assert set(TINY) == {w["name"] for w in manifest.Manifest.load().doc["workloads"]}


def test_no_card_means_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = _run(["benchmark/run.py", "--workload", "mnist_cnn-p10.retrain", "--seed",
                "2147483649", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["benchmark/run.py", "--workload", "mnist_cnn-p10.recon", "--seed", "7",
                "--seconds", "1", "--trace", "1"], cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
r = harness.run_cell({w!r}, 2**31 + 11, 1.0, False, rehearse={over!r})
print(json.dumps({{"result": r, "forbidden": harness.forbidden_modules(),
                   "loaded": sorted(m for m in sys.modules if m.split(".")[0] == "mplc_tpu_torch")[:1]}}))
"""


@pytest.mark.parametrize("workload", sorted(TINY))
def test_rehearsal_of_each_mix_loads_no_jax(workload):
    """A whole run at a tiny size in a process of its own: the result's
    keys and metrics, and no module whose whole top-level name is jax,
    jaxlib, flax or the JAX package (the port's name begins with the JAX
    package's, so names are compared whole)."""
    code = REHEARSE.format(root=str(ROOT), w=workload, over=TINY[workload])
    out = _run(["-c", code], timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line["result"]
    assert line["forbidden"] == [] and line["loaded"] == ["mplc_tpu_torch"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0 and r["failed"] == 0
    assert r["device"] == {"platform": "cpu", "rehearsal": True}
    man = manifest.Manifest.load()
    assert set(r["metrics"]) == set(man.end_to_end_names(workload))
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(man.limits(workload))


STUB_READER = '''"""probe_jax: a reader that loads a module named jax."""

import jax  # noqa: F401


def read(ctx):
    return None
'''

NO_JAX_RUN = """
import sys
sys.path[:0] = [{copy!r}, {root!r}]
from benchmark import harness
try:
    harness.run_cell({w!r}, 2**31 + 13, 1.0, False, rehearse={over!r})
except harness.RunError as e:
    print(e, file=sys.stderr)
    sys.exit(e.code)
print("a result")
"""


def test_a_reader_that_loads_jax_makes_the_run_give_no_result(tmp_path):
    """The run's last step looks for JAX again, after the check and every
    metric's reader: a checkout whose added reader imports a module named
    `jax` (a stand-in, first on the path) exits non-zero with no result."""
    w = "mnist_cnn-p10.recon"
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["end_to_end"].append({"name": "probe_jax", "unit": "s", "better": "lower",
                              "bound": 0.25, "source": "host_clock", "workloads": [w]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (tmp_path / "benchmark" / "metrics" / "probe_jax.py").write_text(STUB_READER)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text('"""A stand-in named jax."""\n')
    code = NO_JAX_RUN.format(copy=str(tmp_path), root=str(ROOT), w=w, over=TINY[w])
    out = _run(["-c", code], timeout=900)
    assert out.returncode == 6, out.stderr[-3000:]
    assert "a result" not in out.stdout and "forbidden modules loaded in the run: jax" in out.stderr


# uniform weights in the sweep are left out: at its tiny size (3 partners)
# they move the first pass by 0.096, under its limit of 0.1 (0.13-0.20 at
# the cell's own size, on the card)
CELL_FAULTS = ([(w, f) for w in ("mnist_cnn-p10.retrain", "cifar10_cnn-p5.sweep")
                for f in ("frozen", "halfbatch", "answer", "lr")]
               + [("mnist_cnn-p10.retrain", "uniform")]
               + [("mnist_cnn-p10.recon", f) for f in ("answer", "frozen", "stale", "uniform")])


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_a_fault_planted_underneath_makes_correct_false(workload, fault):
    """The run with the timed path broken underneath (`faults.py`):
    `correct` comes out false. The reconstruction cell trains nothing in
    its window: an altered answer reaches it there, and a fault of the
    training (a frozen step, stale deltas, wrong weights) through set-up's
    recording."""
    with faults.FAULTS[fault]():
        r = harness.run_cell(workload, 4242, 1.0, False, rehearse=TINY[workload])
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_fails_the_check(workload):
    """The control, the reference in TF32 put in the program's place,
    fails the cell's limits (on the card: TF32 does not exist on the
    CPU)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    from benchmark import check, readings
    man = manifest.Manifest.load()
    over = dict(TINY[workload])
    lines = list(readings.readings(workload, [5], ["fp32", "control"], 1, overrides=over))
    control = next(x for x in lines if x["mode"] == "control")
    assert check.judge(control["readings"], man.limits(workload))[0] is False
