"""How the program serves a request: the entries a mix names.

- `engine`: one `CharacteristicEngine` serves the whole window, a request
  being one `evaluate` call (a user's sweep, request after request); the
  warm-up runs on an engine of its own that shares the staged data.
- `engine_fresh`: every request is a new game's query: a new engine over
  the staged data (`share_data_from`), its memo empty.
- `reconstruction_fresh`: set-up records the grand coalition once
  (`record_updates`, the configuration's recording epochs); every request
  is a new `ReconstructionEvaluator` over that recording, its memo empty.

Each entry exposes `warm(reqs)`, `serve(request)` (its values) and the
objects the check reads afterwards. `progress` is called after every
harvested batch with the batch's coalition count (the engine's hook).
"""

from __future__ import annotations


class EngineEntry:
    fresh = False

    def __init__(self, scenario, progress):
        from mplc_tpu_torch.contrib.engine import CharacteristicEngine
        self._cls = CharacteristicEngine
        self.scenario = scenario
        self.progress = progress
        self.warm_engine = None
        self.engine = None
        self.served = []        # (memo, request) of every request served

    def warm(self, reqs) -> None:
        self.warm_engine = self._cls(self.scenario)
        for r in reqs:
            self.warm_engine.evaluate(r)

    def _engine(self):
        if self.engine is None or self.fresh:
            self.engine = self._cls(self.scenario, share_data_from=self.warm_engine)
            self.engine.progress = lambda done, remaining, slots: self.progress(done)
        return self.engine

    def serve(self, request):
        eng = self._engine()
        self.served.append((eng.charac_fct_values, request))
        return eng.evaluate(request)

    def answers(self) -> list:
        """(request index, coalition, value) of every coalition the window's
        requests completed."""
        out = []
        for i, (memo, req) in enumerate(self.served):
            out += [(i, c, memo[c]) for c in req if c in memo]
        return out


class FreshEngineEntry(EngineEntry):
    fresh = True


class ReconstructionEntry:
    def __init__(self, scenario, progress):
        from mplc_tpu_torch.contrib.engine import CharacteristicEngine
        from mplc_tpu_torch.contrib.reconstruct import ReconstructionEvaluator, record_updates
        self._cls = ReconstructionEvaluator
        self.scenario = scenario
        self.engine = CharacteristicEngine(scenario)
        self.recorded = record_updates(self.engine)
        self.engine.progress = lambda done, remaining, slots: progress(done)
        self.served = []

    def warm(self, reqs) -> None:
        hook, self.engine.progress = self.engine.progress, None
        try:
            for r in reqs:
                self._cls(self.engine, recorded=self.recorded).evaluate(r)
        finally:
            self.engine.progress = hook

    def serve(self, request):
        # the memo alone is kept: each evaluator holds its own flattened
        # copy of the stream on the device, freed with it
        ev = self._cls(self.engine, recorded=self.recorded)
        self.served.append((ev.values, request))
        return ev.evaluate(request)

    answers = EngineEntry.answers


ENTRIES = {"engine": EngineEntry, "engine_fresh": FreshEngineEntry,
           "reconstruction_fresh": ReconstructionEntry}
