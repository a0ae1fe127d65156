"""`python3 -m mplc_tpu_torch.drift_diff` against the JAX package's
`scripts/drift_diff.py`, on the CPU (after tests/test_numerics.py's
drift_diff cases, as one parametrised test):

- both `main`s read the same ledger files, written by the port's engine
  (two same-seed Titanic sweeps) and derived from them: a same-seed pair,
  a perturbed pair (one v(S) one ulp up), a fingerprint mismatch, two
  ledgers of one game with no common subset, and a torn file;
- under each of the flag sets (none, `--gate`, `--json`, `--json --gate`)
  they return the same exit code (0, 1 or 2 as the case says), print the
  same text report or the same `--json` document, and the same error;
- `python3 -m mplc_tpu_torch.drift_diff` runs as a command and imports no
  torch.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mplc_tpu_torch import constants
from mplc_tpu_torch import drift_diff as tdrift
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.obs import numerics
from mplc_tpu_torch.parallel import fleet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import drift_diff as jdrift  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# case -> the exit code both commands give under --gate
CASES = {"same_seed": 0, "perturbed": 1, "fingerprint_mismatch": 2, "no_common": 2,
         "torn": 2}
FLAGS = ([], ["--gate"], ["--json"], ["--json", "--gate"])


def _sweep_ledger(path: Path) -> None:
    """A 3-partner Titanic sweep on the CPU with its ledger at `path`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(constants.NUMERICS_LEDGER_ENV, str(path))
        mp.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
        eng = CharacteristicEngine(fleet.FleetSpec().build_scenario("cpu"))
        eng.evaluate(list(powerset_order(3)))


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory) -> dict:
    """{case: (path a, path b)}."""
    d = tmp_path_factory.mktemp("ledgers")
    a, b = d / "a.json", d / "b.json"
    _sweep_ledger(a)
    _sweep_ledger(b)
    doc = json.loads(b.read_text())
    keys = sorted(doc["entries"])
    assert len(keys) == 7
    bumped = json.loads(json.dumps(doc))
    e = bumped["entries"][keys[3]]
    e["value"] = float(np.nextafter(e["value"], np.inf))
    e["value_bits"] = numerics.float_bits(e["value"])
    other = dict(doc, engine_fingerprint="0123456789abcdef")
    first = dict(doc, entries={k: doc["entries"][k] for k in keys[:3]})
    rest = dict(doc, entries={k: doc["entries"][k] for k in keys[3:]})
    files = {}
    for name, body in (("perturbed", bumped), ("other", other), ("first", first),
                       ("rest", rest)):
        files[name] = d / f"{name}.json"
        files[name].write_text(json.dumps(body))
    torn = d / "torn.json"
    torn.write_text(a.read_text()[:len(a.read_text()) // 2])
    return {"same_seed": (a, b), "perturbed": (a, files["perturbed"]),
            "fingerprint_mismatch": (a, files["other"]),
            "no_common": (files["first"], files["rest"]), "torn": (a, torn)}


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "plain")
@pytest.mark.parametrize("case", sorted(CASES))
def test_drift_diff_matches_the_jax_script(ledgers, case, flags, capsys):
    pa, pb = (str(p) for p in ledgers[case])
    rc_jax = jdrift.main([pa, pb, *flags])
    out_jax = capsys.readouterr()
    rc = tdrift.main([pa, pb, *flags])
    out = capsys.readouterr()
    want = CASES[case] if "--gate" in flags or CASES[case] == 2 else 0
    assert rc == rc_jax == want
    assert out.err == out_jax.err
    if case == "torn":
        assert out.out == out_jax.out == "" and "[drift_diff] error" in out.err
    elif "--json" in flags:
        doc = json.loads(out.out)
        assert doc == json.loads(out_jax.out)
        assert doc["drift"] == (case == "perturbed")
        assert doc["common"] == {"same_seed": 7, "perturbed": 7, "no_common": 0,
                                 "fingerprint_mismatch": 7}[case]
    else:
        assert out.out == out_jax.out
        assert {"same_seed": "ZERO DRIFT", "perturbed": "DRIFT DETECTED",
                "no_common": "NOTHING COMPARED",
                "fingerprint_mismatch": "DIFFERENT GAMES"}[case] in out.out
    if case == "same_seed":
        # two same-seed runs: zero drift, tau-b 1.0, the port's float path
        res = numerics.diff_ledgers(numerics.ValueLedger.load(pa),
                                    numerics.ValueLedger.load(pb))
        assert res["ulp"]["max"] == 0 and res["kendall_tau"] == 1.0
        assert res["meta_a"]["reduction_mode"] == "deterministic"
        assert "a=(1d, part=1, dev=1, deterministic)" in tdrift.format_diff(res, pa, pb)


def test_drift_diff_runs_as_a_command_without_torch(ledgers):
    pa, pb = (str(p) for p in ledgers["perturbed"])
    code = ("import runpy, sys; sys.argv = ['drift_diff', *sys.argv[1:]]\n"
            "try:\n"
            "    runpy.run_module('mplc_tpu_torch.drift_diff', run_name='__main__')\n"
            "finally:\n"
            "    print('torch' in sys.modules, file=sys.stderr)\n")
    out = subprocess.run([sys.executable, "-c", code, pa, pb, "--gate"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": ""})
    assert out.returncode == 1, out.stderr
    assert "DRIFT DETECTED" in out.stdout
    assert out.stderr.strip().splitlines()[-1] == "False"
    cli = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.drift_diff", pa, pa, "--gate"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": ""})
    assert cli.returncode == 0 and "ZERO DRIFT" in cli.stdout
