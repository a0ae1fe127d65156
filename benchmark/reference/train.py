"""The plain reference of the coalition game: a coalition's FedAvg training
(or a lone partner's training), its test accuracy, and the recorded
grand-coalition run with the reconstruction of a coalition from it.

One model at a time, one partner pass at a time, float32, plain autograd:
no batching over coalitions or partners, no slots, no kernels. It follows
MPLC's semantics as the port runs them (each step named below):

- a FedAvg epoch is `minibatch_count` rounds; in each round every member
  starts from the round's global model with a fresh optimizer and takes
  `gradient_updates_per_pass_count` steps over its share of the round's
  minibatch (its rows of the epoch's permutation from
  minibatch * (n // mbc) on, n // mbc rows a round, cut into steps of
  ceil((n // mbc) / gup) rows); the round's global model is then the
  members' models weighted by data volume (each member's row count over
  the members' total);
- a lone partner trains `minibatch_count * gup` steps of one optimizer over
  its rows, in steps of ceil(n / steps) rows;
- each step's loss is the mean categorical cross-entropy over its rows;
  dropout (the CIFAR10 CNN) takes the masks the step's coordinates hash
  to (`streams.step_masks`);
- a coalition's value is its final model's accuracy on the test rows;
- the recorded run is the grand coalition's FedAvg run, each round's
  partner deltas (local model minus the round's start) and data-volume
  weights kept (`record_run`); `grand_rounds` can instead follow a
  recording, each round from the recording's own global model, so that a
  round's deltas are compared without the rounding of the rounds before.

`Partners` holds the partners' training rows as the program stacks them
(padded to the largest partner, a validity mask beside), because the row
orders are drawn over that padded layout.
"""

from __future__ import annotations

import dataclasses

import torch

from . import streams


@dataclasses.dataclass
class Partners:
    x: list          # per partner [n_p, ...] float32 on the reference's device
    y: list          # per partner [n_p, 10] one-hot
    sizes: list      # n_p
    n_max: int

    def host_mask(self) -> torch.Tensor:
        mask = torch.zeros((len(self.sizes), self.n_max))
        for p, n in enumerate(self.sizes):
            mask[p, :n] = 1.0
        return mask


@dataclasses.dataclass(frozen=True)
class Training:
    minibatch_count: int
    gradient_updates: int
    epochs: int


def _loss(spec, params, x, y, masks):
    logits = spec.forward(params, x, masks)
    return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def _leaves(params):
    return [t for d in params.values() for t in d.values()]


def _rebuild(params, leaves):
    it = iter(leaves)
    return {g: {k: next(it) for k in d} for g, d in params.items()}


def train_step(spec, params, opt_state, x, y, masks):
    """One optimizer step on rows (x, y): (params, opt_state). A step
    without rows (a partner too small for its last steps) still steps its
    optimizer, on zero gradients, as MPLC's fixed step count does."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    if len(x):
        loss = _loss(spec, _rebuild(params, leaves), x, y, masks)
        grads = torch.autograd.grad(loss, leaves)
    else:
        grads = [torch.zeros_like(t) for t in leaves]
    with torch.no_grad():
        return spec.optimizer.step(params, _rebuild(params, grads), opt_state)


def _to(params, device):
    return {g: {k: t.to(device) for k, t in d.items()} for g, d in params.items()}


def weighted_sum(models: list, weights: list):
    """sum_i w_i * model_i, leaf by leaf."""
    return {g: {k: torch.sum(torch.stack([w * m[g][k] for m, w in zip(models, weights)]), 0)
                for k in models[0][g]} for g in models[0]}


def fedavg_round(spec, params, parts: Partners, members, perms, key, tr: Training,
                 mb_i: int):
    """One FedAvg round of a coalition: (the members' local models, their
    data-volume weights)."""
    mbc, gup = tr.minibatch_count, tr.gradient_updates
    mb_cap = max(parts.n_max // mbc, 1)
    sb_cap = (mb_cap + gup - 1) // gup
    local_models = []
    for p in members:
        n_mb = parts.sizes[p] // mbc
        sb = (n_mb + gup - 1) // gup
        local, opt_state = params, spec.optimizer.init(params)
        for g in range(gup):
            lo, hi = min(g * sb, n_mb), min((g + 1) * sb, n_mb)
            idx = perms[p, mb_i * n_mb + lo: mb_i * n_mb + hi].to(parts.x[p].device)
            masks = None
            if spec.dropout:
                masks = tuple(m[:hi - lo] for m in streams.step_masks(
                    key, sb_cap, spec.dropout, 1, mb_i, p, g))
            local, opt_state = train_step(spec, local, opt_state, parts.x[p][idx],
                                          parts.y[p][idx], masks)
        local_models.append(local)
    sizes = torch.tensor([float(parts.sizes[p]) for p in members])
    weights = list(sizes / torch.sum(sizes))
    return local_models, weights


def first_step_grads(spec, seed: int, subset, parts: Partners, tr: Training, device) -> dict:
    """{partner: gradient dict} of the first optimizer step of each member
    of coalition `subset`: the first round's first step of a FedAvg member,
    or a lone partner's first step, from the coalition's initial weights."""
    g = streams.coalition_generator(seed, subset)
    params = _to(spec.init(g), device)
    host_mask = parts.host_mask()
    steps = tr.minibatch_count * tr.gradient_updates
    out = {}
    if len(subset) == 1:
        p = subset[0]
        perm = streams.epoch_perms(g, host_mask[p])
        key = streams.draw_key(g).to(device) if spec.dropout else None
        hi = min(-(-parts.sizes[p] // steps), parts.sizes[p])
        rows, coords = max(-(-parts.n_max // steps), 1), (1,)
        plan = [(p, perm[:hi], rows, coords)]
    else:
        perms = streams.epoch_perms(g, host_mask)
        key = streams.draw_key(g).to(device) if spec.dropout else None
        mbc, gup = tr.minibatch_count, tr.gradient_updates
        rows = (max(parts.n_max // mbc, 1) + gup - 1) // gup
        plan = []
        for p in subset:
            n_mb = parts.sizes[p] // mbc
            plan.append((p, perms[p, :min(-(-n_mb // gup), n_mb)], rows, (1, 0, p, 0)))
    for p, idx, rows, coords in plan:
        idx = idx.to(device)
        masks = None
        if spec.dropout:
            masks = tuple(m[:len(idx)] for m in streams.step_masks(key, rows, spec.dropout,
                                                                     *coords))
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        loss = _loss(spec, _rebuild(params, leaves), parts.x[p][idx], parts.y[p][idx], masks)
        out[p] = _rebuild(params, torch.autograd.grad(loss, leaves))
    return out


def train_coalition(spec, seed: int, subset, parts: Partners, tr: Training, device,
                    early: dict | None = None, first_pass_only: bool = False):
    """The final global model of coalition `subset` (a sorted tuple).
    `early`, where given, gets the initial model ("init") and the model
    after the first pass ("pass1"): the first round's aggregate (FedAvg),
    or a lone partner's model after its first `gradient_updates` steps;
    `first_pass_only` returns there."""
    g = streams.coalition_generator(seed, subset)
    params = _to(spec.init(g), device)
    early = {} if early is None else early
    early["init"] = params
    host_mask = parts.host_mask()
    if len(subset) == 1:
        return _train_single(spec, params, g, parts, subset[0], host_mask, tr, device,
                             early, first_pass_only)
    for _ in range(tr.epochs):
        perms = streams.epoch_perms(g, host_mask)
        key = streams.draw_key(g).to(device) if spec.dropout else None
        for mb_i in range(tr.minibatch_count):
            models, weights = fedavg_round(spec, params, parts, subset, perms, key, tr,
                                           mb_i)
            params = weighted_sum(models, [w.to(device) for w in weights])
            if "pass1" not in early:
                early["pass1"] = params
                if first_pass_only:
                    return params
    return params


def _train_single(spec, params, g, parts: Partners, p: int, host_mask, tr: Training,
                  device, early: dict, first_pass_only: bool):
    steps = tr.minibatch_count * tr.gradient_updates
    sb_cap = max((parts.n_max + steps - 1) // steps, 1)
    n = parts.sizes[p]
    sb = (n + steps - 1) // steps
    opt_state = spec.optimizer.init(params)
    for _ in range(tr.epochs):
        perm = streams.epoch_perms(g, host_mask[p])
        key = streams.draw_key(g).to(device) if spec.dropout else None
        for s in range(steps):
            lo, hi = min(s * sb, n), min((s + 1) * sb, n)
            idx = perm[lo:hi].to(device)
            masks = None
            if spec.dropout:
                masks = tuple(m[:hi - lo] for m in streams.step_masks(
                    key, sb_cap, spec.dropout, s + 1))
            params, opt_state = train_step(spec, params, opt_state, parts.x[p][idx],
                                           parts.y[p][idx], masks)
            if s + 1 == tr.gradient_updates and "pass1" not in early:
                early["pass1"] = params
                if first_pass_only:
                    return params
    return params


@torch.no_grad()
def accuracy(spec, params, x_test, y_test, rows: int = 2500) -> float:
    """The share of test rows whose largest logit is the label's."""
    correct = 0
    for s in range(0, len(x_test), rows):
        logits = spec.forward(params, x_test[s:s + rows])
        correct += int((logits.argmax(-1) == y_test[s:s + rows].argmax(-1)).sum())
    return correct / len(x_test)


# ----------------------------------------------------------------------
# the recorded grand-coalition run and the reconstruction
# ----------------------------------------------------------------------

def flat(params, names=None) -> torch.Tensor:
    """The leaves laid end to end, in `names` order ((group, key) pairs;
    None: the dict's own)."""
    names = names or [(g, k) for g, d in params.items() for k in d]
    return torch.cat([params[g][k].reshape(-1) for g, k in names])


def unflat(vec: torch.Tensor, like, names=None):
    """The inverse of `flat`: `vec` cut into `like`'s leaf shapes, laid
    out in `names` order (None: `like`'s own)."""
    names = names or [(g, k) for g, d in like.items() for k in d]
    out, off = {g: {} for g in like}, 0
    for g, k in names:
        n = like[g][k].numel()
        out[g][k] = vec[off:off + n].reshape(like[g][k].shape)
        off += n
    return out


def data_volume_weights(parts: Partners, device) -> torch.Tensor:
    """[P] the grand coalition's aggregation weights: each partner's row
    count over all partners', in float32."""
    sizes = torch.tensor([float(n) for n in parts.sizes], dtype=torch.float32)
    return (sizes / torch.sum(sizes)).to(device)


def grand_rounds(spec, seed: int, parts: Partners, tr: Training, device, names=None,
                 follow=None):
    """Yield (round, its start [D], the partners' deltas [P, D]: local
    model minus start) for each round of the grand coalition's recorded
    run, flattened in `names` order. `follow`, where given, is a recorded
    stream (init [D], deltas [R, P, D], weights [R, P]): each round then
    starts from that stream's global model (its init plus the weighted
    deltas of the rounds before), not from the reference's own."""
    full = tuple(range(len(parts.sizes)))
    g = streams.coalition_generator(seed, full)
    params = _to(spec.init(g), device)
    like = params
    host_mask = parts.host_mask()
    w = data_volume_weights(parts, device)
    cur = follow[0] if follow is not None else None
    r = 0
    for _ in range(tr.epochs):
        perms = streams.epoch_perms(g, host_mask)
        key = streams.draw_key(g).to(device) if spec.dropout else None
        for mb_i in range(tr.minibatch_count):
            if follow is not None:
                params = unflat(cur, like, names)
            models, _ = fedavg_round(spec, params, parts, full, perms, key, tr, mb_i)
            start = flat(params, names)
            yield r, start, torch.stack([flat(m, names) - start for m in models])
            if follow is not None:
                cur = cur + follow[2][r] @ follow[1][r]
            else:
                params = weighted_sum(models, list(w))
            r += 1


def record_run(spec, seed: int, parts: Partners, tr: Training, device, names=None):
    """The reference's own recorded run of the grand coalition: (init [D],
    deltas [R, P, D], weights [R, P])."""
    init, deltas = None, []
    for r, start, d in grand_rounds(spec, seed, parts, tr, device, names):
        init = start if r == 0 else init
        deltas.append(d)
    deltas = torch.stack(deltas)
    return init, deltas, data_volume_weights(parts, device).expand(len(deltas), -1).clone()


def reconstruct(init: torch.Tensor, deltas: torch.Tensor, weights: torch.Tensor,
                member_mask: torch.Tensor) -> torch.Tensor:
    """[D] a coalition's model replayed from a recorded run: init [D],
    deltas [R, P, D], weights [R, P], member_mask [P] 0/1. Each round adds
    the members' deltas weighted by the round's weights renormalized over
    the members (a round whose members all weigh 0 adds nothing)."""
    out = init.clone()
    for r in range(deltas.shape[0]):
        w = weights[r] * member_mask
        total = float(w.sum())
        if total > 0:
            out = out + (w / total) @ deltas[r]
    return out
