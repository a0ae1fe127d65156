"""`python3 -m mplc_tpu_torch.tune_coalition_cap` (the port of
`scripts/tune_coalition_cap.py`) and the engine's `share_data_from`, on
the CPU, one torch thread:

- the tuner on Titanic at `--device cpu`, 5 partners, size-2 coalitions,
  `--block 6 --caps 2,4`: the block rounded up to 8 (the caps' lcm is 4),
  every batch at its cap's width (no padding), finite seconds a coalition,
  the same v(S) bits at both caps (a model trains in calls of one width
  whatever the batch's, so v(S) does not depend on the cap), the best cap
  one of the two; the ambient engine knobs named on stderr and, with the
  cap knob and the noise default, restored on return;
- an engine built with `share_data_from` holds the first engine's staged
  tensors (no second copy) and computes the same fingerprint and the same
  v(S) bits as a freshly staged one;
- the command's `--size` larger than `--partners`, and a block larger than
  the coalitions of that size, are usage errors.
"""

import numpy as np
import pytest
import torch

from mplc_tpu_torch import constants
from mplc_tpu_torch import tune_coalition_cap as tune
from mplc_tpu_torch.contrib.engine import CharacteristicEngine

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--dataset", "titanic", "--partners", "5", "--size", "2",
        "--block", "6", "--caps", "2,4", "--epochs", "2"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in (*tune.AMBIENT_KNOBS, constants.SYNTH_NOISE_ENV,
                 constants.COALITIONS_PER_DEVICE_ENV, constants.DETERMINISTIC_REDUCE_ENV,
                 constants.FAULT_PLAN_ENV, constants.NUMERICS_LEDGER_ENV,
                 constants.PRECISION_ENV):
        monkeypatch.delenv(knob, raising=False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tuner_times_a_padding_free_block_at_each_cap(dtype, monkeypatch, capsys):
    monkeypatch.setenv(constants.NO_SLOTS_ENV, "0")
    monkeypatch.setenv(constants.BATCH_CAP_CEILING_ENV, "64")
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "7")
    res = tune.run([*ARGS, "--dtype", dtype])
    out = capsys.readouterr()
    assert res["block"] == 8 and len(res["subsets"]) == 8
    assert all(len(s) == 2 for s in res["subsets"])
    assert "block 6 -> 8" in out.out
    assert sorted(res["s_per_coalition"]) == [2, 4]
    assert all(np.isfinite(s) and s > 0 for s in res["s_per_coalition"].values())
    assert res["best"] == min(res["s_per_coalition"], key=res["s_per_coalition"].get)
    assert f"best cap: {res['best']}" in out.out
    # batch widths: the cap's own, never padded
    assert "cap=  2:" in out.out and "batch widths [2])" in out.out
    assert "batch widths [4])" in out.out
    v2, v4 = res["values"][2], res["values"][4]
    assert np.isfinite(v2).all() and ((v2 >= 0) & (v2 <= 1)).all()
    assert v2.tobytes() == v4.tobytes()
    for knob in (constants.NO_SLOTS_ENV, constants.BATCH_CAP_CEILING_ENV):
        assert f"[tune] ignoring ambient {knob}" in out.err
    import os
    assert os.environ[constants.NO_SLOTS_ENV] == "0"
    assert os.environ[constants.BATCH_CAP_CEILING_ENV] == "64"
    assert os.environ[constants.COALITIONS_PER_DEVICE_ENV] == "7"
    assert constants.SYNTH_NOISE_ENV not in os.environ


def test_share_data_from_equals_a_freshly_staged_engine():
    sc = tune.make_scenario("titanic", 4, 2, "float32", 2, 3, device="cpu")
    subsets = [(0, 1), (2,), (1, 2, 3), (0, 1, 2, 3)]
    first = CharacteristicEngine(sc)
    shared = CharacteristicEngine(sc, share_data_from=first)
    fresh = CharacteristicEngine(sc)
    assert shared.stacked is first.stacked
    assert shared.val is first.val and shared.test is first.test
    assert fresh.stacked is not first.stacked
    assert shared._fingerprint() == fresh._fingerprint()
    assert shared.evaluate(subsets).tobytes() == fresh.evaluate(subsets).tobytes()


@pytest.mark.parametrize("bad", [["--size", "6"], ["--block", "12"]])
def test_tuner_usage_errors(bad, capsys):
    args = list(ARGS)
    for flag, value in zip(bad[::2], bad[1::2]):
        args[args.index(flag) + 1] = value
    with pytest.raises(SystemExit) as err:
        tune.main(args)
    assert err.value.code == 2
    assert "--size" in capsys.readouterr().err
