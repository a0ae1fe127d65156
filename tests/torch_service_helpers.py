"""Shared scenario factories for the sweep-service tests of the PyTorch port
(tests/test_torch_{service,admission,export,live_ingest}.py): the Titanic
3-partner game of tests/test_service.py in both packages, the service
knobs of both packages cleared, and small accessors."""

import numpy as np
import torch

from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.obs import metrics
from mplc_tpu_torch.scenario import Scenario

P = 3
SUBSETS = powerset_order(P)
AMOUNTS = [0.2, 0.3, 0.5]
# tests/test_service.py's game: 2 epochs, minibatch 2, gup 2
GAME = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)

SERVICE_KNOBS = ("SERVICE_FAULT_PLAN", "SERVICE_MAX_PENDING", "SERVICE_SLICE",
                 "SERVICE_WORKERS", "SERVICE_PRIORITY_DEFAULT", "SERVICE_SHED_P99_SEC",
                 "SERVICE_RETRY_FLOOR_SEC", "FAULT_PLAN", "MAX_RETRIES",
                 "MAX_CAP_HALVINGS", "SEED_ENSEMBLE", "PARTNER_FAULT_PLAN",
                 "METRICS_PORT", "METRICS_TOKEN", "LIVE_INGEST", "LIVE_QUERY_DEADLINE_SEC",
                 "FLEET_STATE_DIR", "PROFILE_DIR", "NO_SLOTS", "SLOT_MERGE", "SLOT_POW2",
                 "DETERMINISTIC_REDUCE", "PROGRAM_BANK")


def clean_env(monkeypatch, tmp_path, cap: "int | None" = 1) -> None:
    """Both packages' service knobs unset, no retry backoff, flight dumps
    into `tmp_path` and, with `cap`, that many coalitions a batch (1: every
    coalition its own batch, so batch ordinals address coalitions, as in
    tests/test_service.py)."""
    torch.set_num_threads(1)
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        monkeypatch.setenv(pkg + "FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    for knob in SERVICE_KNOBS:
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        monkeypatch.setenv(pkg + "RETRY_BACKOFF_SEC", "0")
        if cap is None:
            monkeypatch.delenv(pkg + "COALITIONS_PER_DEVICE", raising=False)
        else:
            monkeypatch.setenv(pkg + "COALITIONS_PER_DEVICE", str(cap))


def scenario(seed: int, partners: int = P, amounts=None, **game) -> Scenario:
    """The port's prepared Titanic scenario on the CPU."""
    sc = Scenario(partners, amounts or AMOUNTS, is_dry_run=True,
                  dataset=tdatasets.load_titanic(), seed=seed, is_early_stopping=False,
                  device="cpu", **{**GAME, **game})
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def jax_scenario(seed: int, partners: int = P, amounts=None, **game):
    """The JAX package's prepared Titanic scenario of the same game."""
    from helpers import build_scenario
    return build_scenario(partners_count=partners,
                          amounts_per_partner=amounts or AMOUNTS,
                          dataset_name="titanic", seed=seed, **{**GAME, **game})


_REF: dict = {}


def solo_values(seed: int) -> np.ndarray:
    """The port's fault-free solo-engine v(S) of `scenario(seed)` (cached;
    the engine's bits do not depend on the batch cap)."""
    if seed not in _REF:
        _REF[seed] = CharacteristicEngine(scenario(seed)).evaluate(SUBSETS)
    return _REF[seed]


def values_of(job) -> np.ndarray:
    return np.array([job.values[s] for s in SUBSETS])


def counter(name: str, module=metrics) -> float:
    return module.snapshot()["counters"].get(name, 0)
