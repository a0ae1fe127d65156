"""Training history: per-partner and global [epoch, minibatch] metric
matrices (a copy of `mplc_tpu/mpl/history.py`, numpy and pandas).

API-compatible with the reference mplc `History`: `history[partner_id]
[metric]` and `history['mpl_model']` matrices, `score`, `nb_epochs_done`,
`partners_to_dataframe()`, `save_data()`. The matrices are filled from the
finished training state's history tensors in one step.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils import pyplot


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


METRICS = ["val_accuracy", "val_loss", "loss", "accuracy"]
# row order of TrainState.partner_h
_PARTNER_H_ROWS = {"loss": 0, "accuracy": 1, "val_loss": 2, "val_accuracy": 3}


class History:
    def __init__(self, partner_ids, epoch_count: int, minibatch_count: int,
                 save_folder=None):
        self.save_folder = Path(save_folder) if save_folder else None
        self.nb_epochs_done = 0
        self.score = None
        self.metrics = list(METRICS)
        nanmat = lambda: np.full((epoch_count, minibatch_count), np.nan)  # noqa: E731
        self.history = {pid: {m: nanmat() for m in self.metrics} for pid in partner_ids}
        self.history["mpl_model"] = {"val_accuracy": np.zeros((epoch_count, minibatch_count)),
                                     "val_loss": np.zeros((epoch_count, minibatch_count))}
        self.theta = None          # lflip: [epoch][partner] K x K matrices
        self.theta_ = None

    def fill_from_state(self, partner_ids, val_loss_h, val_acc_h, partner_h,
                        nb_epochs_done: int, score: float):
        """Ingest the device-side history arrays of a finished TrainState."""
        self.history["mpl_model"]["val_loss"] = np.nan_to_num(_host(val_loss_h))
        self.history["mpl_model"]["val_accuracy"] = np.nan_to_num(_host(val_acc_h))
        ph = _host(partner_h)
        for i, pid in enumerate(partner_ids):
            for metric, row in _PARTNER_H_ROWS.items():
                self.history[pid][metric] = ph[row, i]
        self.nb_epochs_done = int(nb_epochs_done)
        self.score = float(score)

    def fill_theta(self, theta_h, nb_epochs_done: int):
        """lflip: `theta[e][i]`, partner i's theta at the end of epoch e
        (K x K), from the finished state's [E, P, K, K] history; epochs
        never run (early stopping) hold None for every partner."""
        th = _host(theta_h)
        self.theta = [[th[e, i] for i in range(th.shape[1])]
                      if e < nb_epochs_done else [None] * th.shape[1]
                      for e in range(th.shape[0])]

    def partners_to_dataframe(self) -> pd.DataFrame:
        temp = {"Partner": [], "Epoch": [], "Minibatch": []}
        for m in self.metrics:
            temp[m] = []
        for pid, hist in self.history.items():
            if pid == "mpl_model":
                continue
            epoch_count, minibatch_count = self.history["mpl_model"]["val_loss"].shape
            for e in range(epoch_count):
                for mb in range(minibatch_count):
                    temp["Partner"].append(pid)
                    temp["Epoch"].append(e)
                    temp["Minibatch"].append(mb)
                    for metric, matrix in hist.items():
                        temp[metric].append(matrix[e, mb])
        return pd.DataFrame.from_dict(temp)

    def save_data(self):
        """`history_data.p` (the pickled matrices), then, where matplotlib
        is installed, the loss, accuracy and per-partner graphs."""
        if self.save_folder is None:
            return
        with open(self.save_folder / "history_data.p", "wb") as f:
            pickle.dump(self.history, f)
        plt = pyplot()
        if plt is None:
            return

        graphs = self.save_folder / "graphs"
        os.makedirs(graphs, exist_ok=True)
        e_done = max(self.nb_epochs_done, 1)
        last_mb = self.history["mpl_model"]["val_loss"].shape[1] - 1

        plt.figure()
        plt.plot(self.history["mpl_model"]["val_loss"][:e_done, last_mb])
        plt.ylabel("Loss")
        plt.xlabel("Epoch")
        plt.savefig(graphs / "federated_training_loss.png")
        plt.close()

        plt.figure()
        plt.plot(self.history["mpl_model"]["val_accuracy"][:e_done, last_mb])
        plt.ylabel("Accuracy")
        plt.xlabel("Epoch")
        plt.ylim([0, 1])
        plt.savefig(graphs / "federated_training_acc.png")
        plt.close()

        plt.figure()
        for key, value in self.history.items():
            plt.plot(value["val_accuracy"][:e_done, last_mb],
                     label=(f"partner {key}" if key != "mpl_model" else key))
        plt.title("Model accuracy")
        plt.ylabel("Accuracy")
        plt.xlabel("Epoch")
        plt.legend()
        plt.ylim([0, 1])
        plt.savefig(graphs / "all_partners.png")
        plt.close()
