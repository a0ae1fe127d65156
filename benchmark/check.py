"""The comparison that decides `correct`: the program's answers in the
window against the plain reference (`reference/`), run once the window
has closed, on the same card, in float32 with TF32 off. Each number has
its limit in `limits/<workload>.json`; a number the file does not name is
printed as a reading and not compared.

Retraining entries: a sample of the coalitions the window completed,
drawn from the seed and holding the largest, each retrained by the
reference from the same inputs and the same random protocol.

- `v_gap_max`: the widest gap between the program's v(S) and the
  reference's over the sample (test accuracy). Training's rounding grows
  over a coalition's 80 steps, so sound runs part by a few hundredths here
  and a lower precision parts no further: this number catches a model
  that did not train, wrong data or an altered answer.
- The start of each sampled coalition's training, as the optimizer got it
  in the window (`probe.py`). A coalition's models are the probe's rows
  whose initial weights are the reference's (each coalition's are drawn
  from its own seed); each member is matched to the nearest of its
  coalition's rows. Each number is taken by the worst leaf: the gap
  between the program's norm of a leaf and the reference's, over the
  larger of the reference's norm of that leaf and of its median leaf.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out (nought to rounding).
  - `grad1_gap`: the first step's gradient, median member. At one member
    in a dozen or so a max-pool window whose two largest inputs tie to
    rounding routes the gradient through another position, and that
    member's convolution leaves part by ~1e-3 (the widest member is kept
    as the reading `grad1_gap_max`);
  - `grad1_dense_gap`: the same over the leaves after the model's last
    max-pool (`ModelSpec.tie_free`), which no max-pool tie reaches, second
    widest member: wrong rows, labels or loss in any two members fail it.
    Not the widest: at about one seed in six a dense unit whose input lies
    within rounding of ReLU's kink switches on one side only, and that one
    member parts by up to ~3e-4 (the three widest are kept as the reading
    `grad1_dense_top`);
  - `change1_gap`: the parameters' change over the first pass, widest
    coalition: the first round's aggregate (the members' optimizer steps
    and the data-volume weights) or a lone partner's first pass.

The reconstruction entry: the program's recording (set-up's) and its
answers.

- `v_gap_max`: each sampled coalition replayed from the program's
  recording by the reference in plain float32 and evaluated;
- `weights_gap`: the recording's aggregation weights [R, P] against the
  data-volume weights of the reference's own split, exactly;
- `round1_delta_rel`: the recording's start, the first round's partner
  deltas against the reference's own first round from the same inputs,
  |d_program - d_reference| / |d_reference|, median partner (a max-pool
  tie that routes one partner's gradient elsewhere grows over its eight
  steps to a few % of that partner's delta);
- `delta_rel_round`, `delta_rel_partner`: every round's deltas, each
  round trained again by the reference from the recording's own global
  model at that round (its init plus the weighted deltas before), so a
  round is compared without the rounding of the rounds before it; the
  widest round's median partner, and the widest partner's median round.
  A recording worked out again by a second training alone would part from
  the program's by training's rounding, round after round.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .probe import FINGERPRINT
from .reference import train as ref

# a probe row belongs to a coalition where its initial weights are the
# reference's to this (the same draws give the same float32 values)
FP_MATCH = 1e-5


def sample(answers: list, n: int, seed: int) -> list:
    """`n` of the distinct coalitions answered, drawn from the seed, with
    the largest (the first of the largest size) in it."""
    coals = sorted({c for _, c, _ in answers}, key=lambda c: (len(c), c))
    if len(coals) <= n:
        return coals
    rng = np.random.default_rng([int(seed), 0x5A3F1E])
    picked = [coals[i] for i in sorted(rng.choice(len(coals), n, replace=False))]
    largest = max(coals, key=len)
    if largest not in picked:
        picked[0] = largest
    return picked


def _gaps(answers: list, coals: list, values: dict) -> dict:
    gaps = [max(abs(v - values[c]) for _, cc, v in answers if cc == c) for c in coals]
    return {"v_gap_max": max(gaps), "v_gap_mean": float(np.mean(gaps))}


def moving(ref_norms: dict) -> list:
    """The leaves whose reference norm is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(ref_norms.values())))
    return [k for k, v in ref_norms.items() if v >= 1e-3 * med]


def leaf_gap(prog: dict, ref_norms: dict, keys=None, only=()) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm and its median leaf's, over `keys` (default: the
    `moving` leaves), within the groups `only` where given."""
    med = float(np.median(list(ref_norms.values())))
    keys = moving(ref_norms) if keys is None else keys
    keys = [k for k in keys if not only or k[0] in only]
    return max(abs(prog[k] - ref_norms[k]) / max(ref_norms[k], med) for k in keys)


def grad_norms(grads: dict) -> dict:
    return {(g, k): float(torch.linalg.vector_norm(t.float()))
            for g, d in grads.items() for k, t in d.items()}


def fingerprint(params: dict) -> dict:
    return {(g, k): t.reshape(-1)[:FINGERPRINT].float().cpu().tolist()
            for g, d in params.items() for k, t in d.items()}


def _fp_gap(row: dict, ref_fp: dict) -> float:
    return max(abs(a - b) for k, v in ref_fp.items() for a, b in zip(row[k], v))


def reference_view(game, c, tr, device, full: bool = True) -> dict:
    """The reference's coalition `c`: its members' first-step gradient
    norms, its initial weights' fingerprint, the norms of its change over
    the first pass and (`full`) its value."""
    early = {}
    params = ref.train_coalition(game.spec, game.seed, c, game.partners, tr, device, early,
                                 first_pass_only=not full)
    view = {"first": {p: grad_norms(gr) for p, gr in ref.first_step_grads(
                game.spec, game.seed, c, game.partners, tr, device).items()},
            "fingerprint": fingerprint(early["init"]),
            "change": grad_norms({g: {k: early["pass1"][g][k] - t for k, t in d.items()}
                                  for g, d in early["init"].items()})}
    if full:
        view["value"] = ref.accuracy(game.spec, params, game.x_test, game.y_test)
    return view


def start_readings(coals: list, views: dict, steps: list, tie_free: tuple) -> dict:
    """The first-step and first-pass numbers of the sampled coalitions
    against the probe's rows (`FirstStepProbe.rows`)."""
    member, dense, change, unmatched = [], [], [], []
    for c in coals:
        v = views[c]
        rows = [r for r in steps if _fp_gap(r["fingerprint"], v["fingerprint"]) <= FP_MATCH]
        if not rows:
            unmatched.append(list(c))
            continue
        for p, ref_g in v["first"].items():
            best = min(rows, key=lambda r: leaf_gap(r["grad"], ref_g))
            member.append(leaf_gap(best["grad"], ref_g))
            dense.append(leaf_gap(best["grad"], ref_g, only=tie_free))
        # leaves whose gradient the reference moves: any member's first one
        grad_max = {k: max(g[k] for g in v["first"].values()) for k in v["change"]}
        keys = moving(grad_max)
        changes = [leaf_gap(r["change"], v["change"], keys) for r in rows
                   if r["change"] is not None]
        change.append(max(changes) if changes else float("inf"))
    if unmatched or not member:
        # a coalition the window answered that the probe never saw fails
        return {"unmatched": unmatched, "grad1_gap": float("inf"),
                "grad1_dense_gap": float("inf"), "change1_gap": float("inf")}
    dense = sorted(dense, reverse=True)
    return {"unmatched": [], "grad1_gap": float(np.median(member)), "grad1_gap_max": max(member),
            "grad1_dense_gap": dense[min(1, len(dense) - 1)], "grad1_dense_top": dense[:3],
            "change1_gap": max(change)}


def retrain_readings(cfg: dict, mix: dict, answers: list, game, epochs: int, device,
                     cache: dict | None = None, steps: list | None = None,
                     full: bool = True) -> dict:
    """`steps`: the probe's rows; `cache` keeps the reference's work
    between calls on one game; `full` False reads the start alone (the
    reference trains each sampled coalition's first pass only)."""
    coals = sample(answers, int(mix["sample"]), game.seed)
    tr = game.training(cfg, epochs)
    views = {} if cache is None else cache.setdefault("views", {})
    with fp32():
        for c in coals:
            if c not in views or (full and "value" not in views[c]):
                views[c] = reference_view(game, c, tr, device, full)
    out = {"sampled": len(coals)}
    if full:
        out.update(_gaps(answers, coals, {c: views[c]["value"] for c in coals}))
    if steps is not None:
        out.update(start_readings(coals, views, steps, game.spec.tie_free))
    return out


def flat_stream(rec, device) -> tuple:
    """The program's recording as (init [D], deltas [R, P, D], weights
    [R, P], its parameter layout, its leaf order) in float32 on
    `device`."""
    names = [(g, k) for g, d in rec.init_params.items() for k in d]
    init = torch.cat([rec.init_params[g][k].reshape(-1).float().to(device) for g, k in names])
    R, P = rec.weights.shape
    deltas = torch.cat([rec.deltas[g][k].reshape(R, P, -1).float().to(device)
                        for g, k in names], dim=-1)
    return init, deltas, rec.weights.float().to(device), rec.init_params, names


def _rel(d: torch.Tensor, d_ref: torch.Tensor) -> torch.Tensor:
    """[P] |d - d_ref| / |d_ref| a partner."""
    return (torch.linalg.vector_norm(d - d_ref, dim=1)
            / torch.linalg.vector_norm(d_ref, dim=1).clamp(min=1e-30))


def recon_readings(cfg: dict, mix: dict, answers: list, game, stream: tuple, device,
                   cache: dict | None = None) -> dict:
    """`stream`: the recording judged (`flat_stream`'s form); `cache`
    keeps the reference's first round between calls on one game."""
    with fp32():
        return _recon_readings(cfg, mix, answers, game, stream, device, cache)


def _recon_readings(cfg: dict, mix: dict, answers: list, game, stream: tuple, device,
                    cache: dict | None) -> dict:
    coals = sample(answers, int(mix["sample"]), game.seed)
    init, deltas, weights, like, names = stream
    P = weights.shape[1]
    values = {}
    for c in coals:
        mask = torch.zeros(P, device=device)
        mask[list(c)] = 1.0
        params = ref.unflat(ref.reconstruct(init, deltas, weights, mask), like, names)
        values[c] = ref.accuracy(game.spec, params, game.x_test, game.y_test)
    out = _gaps(answers, coals, values) if coals else {}
    out["sampled"] = len(coals)
    tr = game.training(cfg, cfg["recording_epoch_count"])
    cache = {} if cache is None else cache
    key = ("round1", tuple(names) if names else None)
    if key not in cache:
        cache[key] = next(ref.grand_rounds(game.spec, game.seed, game.partners, tr, device,
                                           names))[2]
    rel = _rel(deltas[0], cache[key])
    out["round1_delta_rel"] = float(rel.median())
    out["round1_delta_rel_max"] = float(rel.max())
    out["weights_gap"] = float((weights - ref.data_volume_weights(game.partners, device))
                               .abs().max())
    rel = torch.stack([_rel(deltas[r], d).cpu() for r, _, d in ref.grand_rounds(
        game.spec, game.seed, game.partners, tr, device, names,
        follow=(init, deltas, weights))])
    if rel.shape[0] != deltas.shape[0]:
        raise ValueError(f"the recording holds {deltas.shape[0]} rounds, the configuration "
                         f"{rel.shape[0]}")
    out["delta_rel_round"] = float(rel.median(1).values.max())
    out["delta_rel_partner"] = float(rel.median(0).values.max())
    out["delta_rel_max"] = float(rel.max())
    return out


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers `limits`
    names; a number that was not read fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32():
    """TF32 on for cuBLAS and cuDNN: the nearest precision below the
    configurations' float32 with TF32 off."""
    return _tf32(True)


def fp32():
    """TF32 off for cuBLAS and cuDNN, whatever the process set before (cuDNN
    allows TF32 by default): the reference's precision."""
    return _tf32(False)


def control_retrain(cfg: dict, mix: dict, request: list, game, epochs: int, device,
                    cache: dict, full: bool = True) -> dict:
    """The control: the reference in TF32, put in the program's place for
    the request's sampled coalitions (their values and the start of their
    training), read as a run of the program is."""
    coals = sample([(0, c, 0.0) for c in request], int(mix["sample"]), game.seed)
    tr = game.training(cfg, epochs)
    answers, steps = [], []
    with tf32():
        for c in coals:
            v = reference_view(game, c, tr, device, full)
            answers.append((0, c, v.get("value", 0.0)))
            steps += [{"grad": g, "fingerprint": v["fingerprint"], "change": v["change"]}
                      for g in v["first"].values()]
    return retrain_readings(cfg, mix, answers, game, epochs, device, cache, steps, full)


def control_recon(cfg: dict, mix: dict, request: list, game, recorded, device,
                  cache: dict) -> dict:
    """The control: the reference in TF32 in the program's place, stage by
    stage: the sampled coalitions replayed from the program's recording
    (`recorded`, e.g. a sound fp32 run's) and evaluated, and the recording
    itself, the reference's own recorded run of the grand coalition; read
    as a run of the program is."""
    coals = sample([(0, c, 0.0) for c in request], int(mix["sample"]), game.seed)
    tr = game.training(cfg, cfg["recording_epoch_count"])
    program = flat_stream(recorded, device)
    init, deltas, weights, like, names = program
    answers = []
    with tf32():
        for c in coals:
            mask = torch.zeros(weights.shape[1], device=device)
            mask[list(c)] = 1.0
            params = ref.unflat(ref.reconstruct(init, deltas, weights, mask), like, names)
            answers.append((0, c, ref.accuracy(game.spec, params, game.x_test, game.y_test)))
        own = ref.record_run(game.spec, game.seed, game.partners, tr, device, names)
    del init, deltas, program
    replay = recon_readings(cfg, mix, answers, game, flat_stream(recorded, device), device,
                            cache)
    out = recon_readings(cfg, mix, [], game, own + (like, names), device, cache)
    out.update({k: replay[k] for k in ("v_gap_max", "v_gap_mean", "sampled")})
    return out
