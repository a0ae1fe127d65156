"""The start of each batch's training, as the optimizer sees it.

Training's rounding grows over a coalition's 80 steps into differences of
v(S) as large as those of a lower precision (on an H100, at the cells'
sizes), so the check also compares the start of each training.
`FirstStepProbe` wraps a model's optimizer through the program's `Model`
contract (`init`, `step`); it changes no value and reads nothing to the
host inside the window. Armed (`arm`, at the window's start and after each
batch), it keeps, for every model of the batch:

- at the next step of a fresh optimizer state (`count` 0: a batch's first
  round, or its lone partners' first step): the norm of each leaf of the
  gradient the step gets, and the first `FINGERPRINT` values of each leaf
  of the parameters it gets (the initial weights, which name the model's
  coalition: each coalition's weights are drawn from its own seed);
- at the next step that starts a pass (`count` 0 again: the second round,
  after the first round's aggregation; or `count` = the steps of a pass:
  a lone partner after its first pass): the norm of each leaf of the
  parameters' change since the first step.

It then disarms until it is armed again.
"""

from __future__ import annotations

import torch

FINGERPRINT = 8


def _per_model(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).float()


class FirstStepProbe:
    def __init__(self, inner, pass_steps: int):
        self.inner = inner
        self.pass_steps = pass_steps
        self.armed = False
        self.steps = []       # [{"names", "grad", "fingerprint", "change"}] on the device
        self._start = None    # the parameters of the armed batch's first step

    def arm(self) -> None:
        self.armed = True
        self._start = None

    def disarm(self) -> None:
        self.armed = False
        self._start = None

    def init(self, params):
        return self.inner.init(params)

    def step(self, params, grads, state):
        count = state.get("count")
        if self.armed and self._start is None and count == 0:
            names = [(g, k) for g, d in grads.items() for k in d]
            self.steps.append({
                "names": names,
                "grad": torch.stack([torch.linalg.vector_norm(_per_model(grads[g][k]), dim=1)
                                     for g, k in names], 1),
                "widths": [min(FINGERPRINT, params[g][k][0].numel()) for g, k in names],
                "fingerprint": torch.cat([_per_model(params[g][k])[:, :FINGERPRINT]
                                          for g, k in names], 1),
                "change": None})
            self._start = params
        elif self.armed and self._start is not None and count in (0, self.pass_steps):
            names = self.steps[-1]["names"]
            self.steps[-1]["change"] = torch.stack([torch.linalg.vector_norm(
                _per_model(params[g][k] - self._start[g][k]), dim=1) for g, k in names], 1)
            self.disarm()
        return self.inner.step(params, grads, state)

    def rows(self) -> list:
        """[{"grad": {(group, key): norm}, "fingerprint": {(group, key):
        [values]}, "change": {(group, key): norm} or None}] of every model
        of every kept batch, read to the host."""
        out = []
        for s in self.steps:
            names = s["names"]
            grads = s["grad"].cpu().tolist()
            fps = s["fingerprint"].cpu().tolist()
            changes = s["change"].cpu().tolist() if s["change"] is not None else None
            ends = [sum(s["widths"][:i + 1]) for i in range(len(names))]
            for i, (gr, fp) in enumerate(zip(grads, fps)):
                out.append({"grad": dict(zip(names, gr)),
                            "fingerprint": {n: fp[e - w:e] for n, e, w
                                            in zip(names, ends, s["widths"])},
                            "change": dict(zip(names, changes[i])) if changes else None})
        return out
