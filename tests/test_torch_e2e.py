"""The reference's end-to-end oracles on the port's CPU path, one torch
thread (the port's counterparts of tests/test_e2e.py:138-183, which run the
JAX package and are `slow`; these take seconds on Titanic):

- a 0.1 / 0.9 split: the 0.9 partner out-scores the 0.1 partner under
  exact Shapley, Independent scores and TMCS, the fit passes the
  reference's CI gate for Titanic (0.65), and the run leaves its coalition
  cache for a resume;
- a fully label-flipped largest partner (0.5 of the data) ranks last under
  exact Shapley: data volume argues for it, so only detection can rank it
  last.
"""

import torch

from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

GAME = dict(dataset_name="titanic", epoch_count=6, minibatch_count=2,
            gradient_updates_per_pass_count=3, is_early_stopping=False, seed=6,
            device="cpu")


def test_contributivity_ordering_oracle(tmp_path):
    sc = Scenario(partners_count=2, amounts_per_partner=[0.1, 0.9],
                  methods=["Shapley values", "Independent scores", "TMCS"],
                  experiment_path=str(tmp_path), **GAME)
    sc.run()
    assert sc.mpl.history.score > 0.65
    assert [c.name for c in sc.contributivity_list] == \
        ["Shapley", "Independent scores raw", "TMC Shapley"]
    for contrib in sc.contributivity_list:
        s = contrib.contributivity_scores
        assert s[1] > s[0], f"{contrib.name}: {s}"
    assert (sc.save_folder / "coalition_cache.json").exists()


def test_corrupted_partner_detection_oracle(tmp_path):
    sc = Scenario(partners_count=3, amounts_per_partner=[0.2, 0.3, 0.5],
                  corrupted_datasets=["not_corrupted", "not_corrupted", "corrupted"],
                  methods=["Shapley values"], experiment_path=str(tmp_path), **GAME)
    sc.run()
    s = sc.contributivity_list[0].contributivity_scores
    assert s[2] < s[0] and s[2] < s[1], f"the fully label-flipped 0.5 partner must rank last: {s}"
