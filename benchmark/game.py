"""A configuration's game, made from the run's seed for both sides.

`make_inputs` draws the raw arrays once (`reference/datasets/<kind>.py`);
`program_scenario` hands them to the program as a `Dataset` and prepares
its `Scenario` as MPLC prepares one (partners, the basic random split,
batch sizes), its model's optimizer seen through the check's probe;
`reference_game` splits the same arrays with the reference's own copies
of the splits. The seed moves the data, the
initial weights (each coalition's stream is seeded from it) and the
dropout draws; it never moves which coalitions the traffic asks for.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from . import reference
from .probe import FirstStepProbe
from .reference import split
from .reference.train import Partners, Training


def amounts(cfg: dict) -> list:
    """Each partner's share of the training rows: its weight over the sum
    (partner i weighs i + 1 in both configurations)."""
    w = [float(v) for v in cfg["partner_weights"]]
    return [v / sum(w) for v in w]


def make_inputs(cfg: dict, seed: int) -> dict:
    data = dict(cfg["data"])
    return reference.dataset(data.pop("kind"))(seed, **data)


def program_scenario(cfg: dict, raw: dict, seed: int, device, epochs: int):
    """The program's prepared `Scenario` over `raw`, training `epochs`."""
    from mplc_tpu_torch.data.datasets import Dataset, with_held_out_test
    from mplc_tpu_torch.models.zoo import MODELS
    from mplc_tpu_torch.scenario import Scenario

    # the model with its optimizer seen through the check's probe
    # (`probe.py`), which changes nothing the program computes
    model = MODELS[cfg["model"]]
    model = dataclasses.replace(model, optimizer=FirstStepProbe(
        model.optimizer, cfg["gradient_updates_per_pass_count"]))
    x_te = raw.get("x_test", raw["x_train"][:0])
    y_te = raw.get("y_test", raw["y_train"][:0])
    ds = Dataset(cfg["dataset_name"], raw["x_train"].shape[1:], raw["y_train"].shape[1],
                 raw["x_train"], raw["y_train"], x_te, y_te, model=model,
                 provenance=f"benchmark:{cfg['data']['kind']}")
    if cfg.get("held_out_test_rows"):
        ds = with_held_out_test(ds, cfg["held_out_test_rows"])
    sc = Scenario(partners_count=len(cfg["partner_weights"]), amounts_per_partner=amounts(cfg),
                  dataset=ds,
                  multi_partner_learning_approach=cfg["multi_partner_learning_approach"],
                  aggregation_weighting=cfg["aggregation_weighting"], epoch_count=epochs,
                  minibatch_count=cfg["minibatch_count"],
                  gradient_updates_per_pass_count=cfg["gradient_updates_per_pass_count"],
                  is_early_stopping=cfg["is_early_stopping"],
                  compute_dtype=cfg["compute_dtype"],
                  experiment_path=os.path.join(tempfile.gettempdir(), "benchmark-experiments"),
                  is_dry_run=True, seed=seed, device=device)
    sc.instantiate_scenario_partners()
    sc.split_data(is_logging_enabled=False)
    sc.compute_batch_sizes()
    sc.data_corruption()
    return sc


@dataclasses.dataclass
class ReferenceGame:
    spec: object
    partners: Partners
    x_test: object
    y_test: object
    seed: int

    def training(self, cfg: dict, epochs: int) -> Training:
        return Training(cfg["minibatch_count"], cfg["gradient_updates_per_pass_count"],
                        epochs)


def reference_game(cfg: dict, raw: dict, seed: int, device) -> ReferenceGame:
    """The reference's view of the same arrays, on `device`."""
    import torch

    if cfg.get("held_out_test_rows"):
        x_tr, y_tr, _, _, x_te, y_te = split.held_out_test(
            raw["x_train"], raw["y_train"], cfg["held_out_test_rows"])
    else:
        x_tr, y_tr, _, _ = split.train_val_split(raw["x_train"], raw["y_train"])
        x_te, y_te = raw["x_test"], raw["y_test"]
    parts = split.partner_split(len(x_tr), amounts(cfg))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    partners = Partners(x=[to(x_tr[i]) for i in parts], y=[to(y_tr[i]) for i in parts],
                        sizes=[len(i) for i in parts], n_max=max(len(i) for i in parts))
    return ReferenceGame(reference.model(cfg["model"]), partners, to(x_te), to(y_te), seed)
