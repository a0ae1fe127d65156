"""Start N ranks of a world on this host, and the several-card self-check.

    python3 -m mplc_tpu_torch.parallel.launch --nproc N --selfcheck [--device cpu]

`spawn(target, nproc, args)` starts `nproc` processes with
`torch.multiprocessing` (spawn), each with the environment `torchrun`
gives a rank (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT on a free port of the loopback), forms the world
(`mesh.init_world`: NCCL on the cards, rank r on card r, gloo on the CPU),
calls `target` ("module:function") with `args` and returns every rank's
return value, in rank order. The ranks are joined under one time limit;
a rank that raises, dies or outlives it fails the call with every rank's
error, and no rank outlives the call: the others get `PEER_GRACE_SEC` to
end after one failed, and every rank dies with the process that spawned
it. The CPU tests use it in place of the
JAX tests' 8-device host mesh, one torch thread a rank.

`--selfcheck` runs the several-card checks in one call and prints their
lines and one JSON line; it exits 1 when a check fails:

  (a) a [2 coal x 2 part] mesh of the N = 4 ranks on bench config 1's game
      (the MNIST CNN at full width, 10 partners, 5 a rank), 16 coalitions
      of 2 epochs under the deterministic reduce: the v(S) table bit-equal
      to the same game on a world of 1 (zero ulp, tau-b 1.0 through
      `obs.numerics.diff_ledgers`);
  (b) the same game under the default reduce, every v(S) within
      `DEFAULT_REDUCE_BOUND` of (a): the partners' sums associate otherwise,
      and the reference promises the default reduce only the same game at a
      coarse tolerance (tests/test_partner_shard.py's
      `test_partner_sharded_default_mode_still_drifts_documented`; the
      strict promise is (a)'s). Its gap in test samples, its distance from
      the default reduce on one rank, and that run's from the deterministic
      one's, are printed beside; then the same on the games of `B_SEEDS`
      (`--b-seeds`), each held to one rank's deterministic reduce there;
  (c) a [4 coal x 1 part] layout, the 1-D coalition sharding of the same 16
      coalitions, bit-equal to the world of 1;
  (d) the sweep service in one process with 4 workers, worker i on card
      i % 4: every tenant's table bit-equal to a solo engine's;
  (e) the [2 x 2] engine with one cap halving allowed, rank 1's partner-
      sharded trainings failing with an OOM from their second round on:
      every rank ends with LadderExhaustedError(mode="2d"), well inside
      the groups' timeout (the failed rank reports to its row's next
      agreement point).

Each prints its seconds and, for (a)-(c), the collectives a round.
`--dataset titanic` runs the same checks on Titanic's 4 partners (a
rehearsal on the CPU: `--device cpu`).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from .. import constants, faults
from . import mesh


# seconds the other ranks of a world get to end after one failed
PEER_GRACE_SEC = 15.0


class RankFailed(RuntimeError):
    """A spawned world failed: `errors` maps each failed rank to its
    traceback (or exit status)."""

    def __init__(self, errors: dict):
        self.errors = errors
        super().__init__("; ".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """Have the kernel end this rank when the process that spawned it dies
    (Linux's parent-death signal), so no rank outlives a killed launcher,
    a fleet worker included. Elsewhere a no-op."""
    try:
        import ctypes
        import signal
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank_main(rank: int, nproc: int, port: int, target: str, args: tuple, env: dict,
               out: str, device: str, threads: int) -> None:
    _die_with_parent()
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nproc),
                      LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # one host: the world's sockets stay on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(threads)
    try:
        mesh.init_world(device)
        # the rank's card and deterministic modes before any cuBLAS call
        from ..utils import resolve_device
        resolve_device(device)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mesh.destroy_world()


def _join(procs: list, timeout: float) -> "int | None":
    """Wait until every rank has ended, the time limit is past, or
    `PEER_GRACE_SEC` after the first rank that failed; the failed rank's
    index, or None."""
    deadline = time.monotonic() + timeout
    failed = grace_end = None
    while any(p.is_alive() for p in procs):
        now = time.monotonic()
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None:
                grace_end = now + PEER_GRACE_SEC
        if now >= deadline or (grace_end is not None and now >= grace_end):
            break
        time.sleep(0.05)
    return failed


def spawn(target: str, nproc: int, args: tuple = (), device: str = "cpu",
          env: dict | None = None, timeout: float = 90.0, threads: int = 1,
          port: int | None = None) -> list:
    """Every rank's `target(*args)` (see the module docstring), in rank
    order. `env` is added to each rank's environment before the world
    forms; `port` is the world's MASTER_PORT (None: a free one). A rank
    still running `PEER_GRACE_SEC` after another failed is killed: its
    peers of a collective would otherwise wait out the group's timeout."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = port or free_port()
    with tempfile.TemporaryDirectory(prefix="mplc_ranks_") as out:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nproc, port, target, tuple(args), dict(env or {}), out,
                                   device, threads))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        failed = None
        try:
            failed = _join(procs, timeout)
        finally:
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errors = {}
        for r, p in enumerate(procs):
            err = os.path.join(out, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors[r] = f.read()
            elif r in late and failed is not None:
                errors[r] = f"killed {PEER_GRACE_SEC:g} s after rank {failed} failed"
            elif r in late:
                errors[r] = f"still running after {timeout} s, killed"
            elif p.exitcode != 0:
                errors[r] = f"exited with status {p.exitcode}"
        if errors:
            raise RankFailed(errors)
        results = []
        for r in range(nproc):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


# ---------------------------------------------------------------------------
# the self-check
# ---------------------------------------------------------------------------

# bench config 1's game (chip_smoke.py's slice: synthetic MNIST at scale
# 0.2, noise 0.75), and Titanic's 4 partners for a rehearsal
GAMES = {"mnist": dict(dataset="mnist", partners=10, epochs=2, minibatch_count=10,
                       gradient_updates_per_pass=8),
         "titanic": dict(dataset="titanic", partners=4, epochs=2, minibatch_count=2,
                         gradient_updates_per_pass=2)}
DATA_KNOBS = {constants.SYNTH_SCALE_ENV: "0.2", constants.SYNTH_NOISE_ENV: "0.75"}
COALITIONS = 16
# (a)-(c): partner shards (None: the knob unset) and the deterministic reduce
CASES = {"a": (2, True), "b": (2, False), "c": (None, True)}
# (b) is read again on the games of these seeds (the game's own is 0),
# each against one rank's deterministic and default reduce
B_SEEDS = (1, 2)
# (b)'s bound on |v(S) - v(S) of the deterministic reduce|, in any v(S):
# the port's bf16 bound (chip_smoke.py's BF16_VALUE_BOUND). One rank's two
# reductions already part by up to 17 test samples (0.0085) on the MNIST
# game, and [2 x 2] by 0.0095 (PERF.md, section 6)
DEFAULT_REDUCE_BOUND = 0.05
SERVICE_TENANTS = 4
SERVICE_PARTNERS = 4


def _spec(dataset: str):
    from .fleet import FleetSpec
    return FleetSpec(**GAMES[dataset])


def selfcheck_subsets(partners: int, n: int = COALITIONS) -> list:
    """`n` coalitions spread over the powerset's order: every k-th, so the
    singles' sliced path and every coalition size up to the grand
    coalition's neighbours take part."""
    from ..contrib.shapley import powerset_order
    order = list(powerset_order(partners))
    return order[::max(1, len(order) // n)][:n]


def _knobs(partner_shards, deterministic: bool, ledger: str | None) -> dict:
    env = dict(DATA_KNOBS)
    env[constants.DETERMINISTIC_REDUCE_ENV] = "1" if deterministic else ""
    env[constants.PARTNER_SHARDS_ENV] = "" if partner_shards is None else str(partner_shards)
    env[constants.NUMERICS_LEDGER_ENV] = ledger or ""
    return env


def measure(eng, subsets: list) -> dict:
    """`eng`'s sweep of `subsets`: its values, seconds, ledger meta, layout
    and the collectives it issued, over all and a round (the weight
    collectives over the rounds its multi batches ran)."""
    before = mesh.collectives()
    if torch.device(eng.device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = eng.evaluate(subsets)
    seconds = time.perf_counter() - t0
    issued = {k: v - before[k] for k, v in mesh.collectives().items() if v > before[k]}
    cfg = eng._multi_cfg
    rounds = sum(cfg.epoch_count * cfg.minibatch_count
                 for b in eng.batch_log if b["kind"] == "multi")
    weights = issued.get("all_gather", 0) + issued.get("all_reduce", 0)
    pipe = eng._pipe2d
    return {"values": values.tolist(), "seconds": seconds, "meta": eng._ledger_meta(),
            "layout": ([pipe.coal_devices, pipe.part_shards] if pipe is not None
                       else [eng._sharding.num_devices if eng._sharding else 1, 1]),
            "collectives": issued, "rounds": rounds,
            "collectives_per_round": weights / rounds if rounds else 0.0,
            "n_test": int(len(eng.scenario.dataset.x_test)),
            "batches": [(b["kind"], b["width"], round(b["seconds"], 4))
                        for b in eng.batch_log]}


def run_game(dataset: str, subsets: list, device: str, knobs: dict, seed: int = 0) -> dict:
    """`measure` of a fresh engine on the game `dataset` (its `seed`) under
    `knobs`."""
    from ..contrib.engine import CharacteristicEngine
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        spec = dataclasses.replace(_spec(dataset), seed=seed)
        return measure(CharacteristicEngine(spec.build_scenario(device)), subsets)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def selfcheck_rank(dataset: str, subsets: list, device: str, out: str,
                   b_seeds: tuple = ()) -> dict:
    """One rank's (a)-(c), then (b) on the games of `b_seeds`; the ledgers
    land in `out` (rank 0's)."""
    rank = mesh.world_rank()
    res = {}
    for case, (part, det) in CASES.items():
        ledger = os.path.join(out, f"{case}.json") if rank == 0 else None
        res[case] = run_game(dataset, subsets, device, _knobs(part, det, ledger))
    part, det = CASES["b"]
    for seed in b_seeds:
        res[f"b{seed}"] = run_game(dataset, subsets, device, _knobs(part, det, None), seed)
    res["e"] = oom_in_round(dataset, [s for s in subsets if len(s) > 1], device, out)
    return res


def oom_in_round(dataset: str, subsets: list, device: str, out: str) -> dict:
    """(e): the [2 x 2] engine's sweep of `subsets` (multis: the 2-D
    pipeline) with one cap halving allowed while rank 1's partner-sharded
    trainings raise an OOM from their second round on; what each rank
    ended with, and its seconds. The ladder's flight dumps land in `out`."""
    from ..mpl.engine import MplTrainer
    from ..obs import flight
    real, rounds = MplTrainer._steps, [0]

    def steps(self, *a, **kw):
        if self.cfg.partner_axis is not None and mesh.world_rank() == 1:
            rounds[0] += 1
            if rounds[0] > 1:
                raise faults.InjectedOom("CUDA out of memory: injected inside a round")
        return real(self, *a, **kw)
    MplTrainer._steps = steps
    t0 = time.perf_counter()
    try:
        run_game(dataset, subsets, device,
                 {**_knobs(2, True, None), constants.MAX_CAP_HALVINGS_ENV: "1",
                  flight.FLIGHT_DIR_ENV: out})
        ended = None
    except Exception as e:  # noqa: BLE001 - what this rank ended with
        ended = [type(e).__name__, getattr(e, "mode", None), getattr(e, "halvings", None)]
    finally:
        MplTrainer._steps = real
    return {"ended": ended, "seconds": time.perf_counter() - t0, "rounds": rounds[0]}


def selfcheck_service(device: str) -> dict:
    """(d): SERVICE_TENANTS Titanic tenants through one service of as many
    workers (worker i on card i % n), each held bit-equal to a solo engine."""
    from ..contrib.engine import CharacteristicEngine
    from ..contrib.shapley import powerset_order
    from ..service.scheduler import SweepService

    def game(seed):
        spec = dataclasses.replace(_spec("titanic"), partners=SERVICE_PARTNERS, seed=seed)
        return spec.build_scenario(device)

    class Service(SweepService):
        def _release_engine_data(self, job):
            job._card = str(job.engine.stacked.x.device)
            super()._release_engine_data(job)

    subsets = list(powerset_order(SERVICE_PARTNERS))
    seeds = range(3, 3 + SERVICE_TENANTS)
    solo = {s: CharacteristicEngine(game(s)).evaluate(subsets) for s in seeds}
    t0 = time.perf_counter()
    saved = os.environ.get(constants.SERVICE_WORKERS_ENV)
    os.environ[constants.SERVICE_WORKERS_ENV] = str(SERVICE_TENANTS)
    try:
        svc = Service(slice_coalitions=3)
        jobs = {s: svc.submit(game(s), tenant=f"t{s}") for s in seeds}
        slots = [w.device_slot for w in svc._workers]
        for j in jobs.values():
            j.result(timeout=600)
        svc.shutdown()
    finally:
        if saved is None:
            os.environ.pop(constants.SERVICE_WORKERS_ENV, None)
        else:
            os.environ[constants.SERVICE_WORKERS_ENV] = saved
    equal = {s: np.array([j.values[k] for k in subsets]).tobytes() == solo[s].tobytes()
             for s, j in jobs.items()}
    return {"seconds": time.perf_counter() - t0, "equal": all(equal.values()),
            "workers": slots,
            "cards": sorted({getattr(j, "_card", "?") for j in jobs.values()})}


def _smi() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def selfcheck(nproc: int, device: str, dataset: str, timeout: float,
              b_seeds: tuple = B_SEEDS) -> int:
    from ..obs import numerics
    if nproc != 4:
        raise SystemExit("--selfcheck lays out [2 x 2] and [4 x 1] meshes: it needs --nproc 4")
    smi = _smi() if torch.device(device).type == "cuda" else "cpu"
    spec = _spec(dataset)
    subsets = selfcheck_subsets(spec.partners)
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(what)
            print(f"[selfcheck] FAILED: {what}", flush=True)

    with tempfile.TemporaryDirectory(prefix="mplc_selfcheck_") as out:
        t0 = time.perf_counter()
        ranks = spawn(f"{__name__}:selfcheck_rank", nproc,
                      (dataset, subsets, device, out, tuple(b_seeds)),
                      device=device, timeout=timeout,
                      threads=1 if device == "cpu" else max(1, (os.cpu_count() or 1) // nproc))
        world_s = time.perf_counter() - t0
        ref_ledger = os.path.join(out, "ref.json")
        ref = run_game(dataset, subsets, device, _knobs(None, True, ref_ledger))
        ref_led = numerics.ValueLedger.load(ref_ledger)
        # the default reduce on one rank: what (b) parts from besides (a)
        ref_default = np.array(run_game(dataset, subsets, device,
                                        _knobs(None, False, None))["values"])
        res = ranks[0]
        print(f"[selfcheck] {spec.dataset} {spec.partners} partners, {len(subsets)} "
              f"coalitions, {spec.epochs} epochs; world of {nproc} spawned and run in "
              f"{world_s:.2f} s; world of 1: {ref['seconds']:.2f} s, layout {ref['layout']}, "
              f"batches {ref['batches']}; {smi}", flush=True)
        lines = {}
        for case, (part, det) in CASES.items():
            r = res[case]
            same = all(rk[case]["values"] == r["values"] for rk in ranks)
            check(same, f"({case}) the ranks' value tables differ")
            if det:
                d = numerics.diff_ledgers(ref_led, numerics.ValueLedger.load(
                    os.path.join(out, f"{case}.json")))
                ok = (d["ulp"]["max"] == 0 and d["kendall_tau"] == 1.0
                      and d["common"] == len(subsets) and not d["drift"])
                check(ok, f"({case}) differs from the world of 1: {json.dumps(d)[:400]}")
                how = f"max ulp {d['ulp']['max']}, tau-b {d['kendall_tau']}, {d['common']} common"
            else:
                gap = float(np.abs(np.array(r["values"]) - np.array(res["a"]["values"])).max())
                check(gap <= DEFAULT_REDUCE_BOUND,
                      f"({case}) parts from (a) by {gap} > {DEFAULT_REDUCE_BOUND}")
                v = np.array(r["values"])
                how = (f"max |v - v(a)| {gap:.6f}, bound {DEFAULT_REDUCE_BOUND} "
                       f"({gap * r['n_test']:.0f} test samples of {1 / r['n_test']:.6f}); "
                       f"against the default reduce on one rank max |v - v1| "
                       f"{float(np.abs(v - ref_default).max()):.6f}, that run against the "
                       f"deterministic one's {float(np.abs(ref_default - ref['values']).max()):.6f}")
            lines[case] = {"seconds": r["seconds"], "layout": r["layout"], "meta": r["meta"],
                           "collectives_per_round": r["collectives_per_round"],
                           "collectives": r["collectives"], "rounds": r["rounds"]}
            print(f"[selfcheck] ({case}) layout {r['layout']} [coal x part], reduce "
                  f"{'deterministic' if det else 'default'}: {r['seconds']:.2f} s on rank 0, "
                  f"{r['collectives_per_round']:.2f} weight collectives a round over "
                  f"{r['rounds']} rounds ({r['collectives']}); ledger meta {r['meta']}; "
                  f"{how}; batches {r['batches']}; {smi}", flush=True)
        for seed in b_seeds:
            # (b) on another seed's game, against one rank's deterministic
            # reduce there (what (a) equals) and its default reduce
            r = res[f"b{seed}"]
            v = np.array(r["values"])
            det1, def1 = (np.array(run_game(dataset, subsets, device, _knobs(None, d, None),
                                            seed)["values"]) for d in (True, False))
            gap = float(np.abs(v - det1).max())
            check(all(rk[f"b{seed}"]["values"] == r["values"] for rk in ranks),
                  f"(b) seed {seed}: the ranks' value tables differ")
            check(gap <= DEFAULT_REDUCE_BOUND,
                  f"(b) seed {seed} parts from the deterministic reduce by {gap} > "
                  f"{DEFAULT_REDUCE_BOUND}")
            lines[f"b{seed}"] = {"seconds": r["seconds"], "gap": gap,
                                 "gap_default_1": float(np.abs(v - def1).max()),
                                 "gap_1": float(np.abs(def1 - det1).max())}
            print(f"[selfcheck] (b) seed {seed}: {r['seconds']:.2f} s on rank 0; max |v - "
                  f"v(det, 1 rank)| {gap:.6f}, bound {DEFAULT_REDUCE_BOUND} ({gap * r['n_test']:.0f} "
                  f"test samples of {1 / r['n_test']:.6f}); "
                  f"against the default reduce on one rank "
                  f"{lines[f'b{seed}']['gap_default_1']:.6f}, that run against the "
                  f"deterministic one's {lines[f'b{seed}']['gap_1']:.6f}; {smi}", flush=True)
        check(res["a"]["layout"] == [2, 2] and res["c"]["layout"] == [4, 1],
              f"layouts {res['a']['layout']}, {res['c']['layout']}")
        check(res["a"]["meta"]["topology"] == "2d" and res["a"]["meta"]["part_shards"] == 2
              and res["a"]["meta"]["n_devices"] == nproc
              and res["c"]["meta"]["topology"] == "1d",
              f"ledger meta {res['a']['meta']}, {res['c']['meta']}")
    e = [rk["e"] for rk in ranks]
    check(all(x["ended"] == ["LadderExhaustedError", "2d", 2] for x in e),
          f"(e) the ranks ended with {[x['ended'] for x in e]}")
    print(f"[selfcheck] (e) [2 x 2], an OOM inside rank 1's rounds: every rank ended with "
          f"{[x['ended'] for x in e]} in {max(x['seconds'] for x in e):.2f} s (rank 1's "
          f"rounds {e[1]['rounds']}); {smi}", flush=True)
    lines["e"] = {"seconds": max(x["seconds"] for x in e), "ended": [x["ended"] for x in e]}
    d = selfcheck_service(device)
    check(d["equal"], "(d) a service tenant differs from its solo run")
    print(f"[selfcheck] (d) service, {SERVICE_TENANTS} workers on device slots "
          f"{d['workers']}, tenants trained on {d['cards']}: {d['seconds']:.2f} s, every "
          f"tenant bit-equal to solo: {d['equal']}; {smi}", flush=True)
    print(json.dumps({"ok": not failures, "failures": failures, "cases": lines,
                      "world_s": world_s, "reference_s": ref["seconds"], "service": d,
                      "card": smi}))
    return 0 if not failures else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mplc_tpu_torch.parallel.launch")
    ap.add_argument("--nproc", type=int, required=True, help="ranks to start on this host")
    ap.add_argument("--selfcheck", action="store_true", help="run the several-card checks")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, rank r on card r) or cpu")
    ap.add_argument("--dataset", default="mnist", choices=sorted(GAMES))
    ap.add_argument("--timeout", type=float, default=600.0, help="the world's time limit")
    ap.add_argument("--b-seeds", type=int, nargs="*", default=list(B_SEEDS),
                    help="game seeds (b) is read on besides the game's own")
    args = ap.parse_args(argv)
    if not args.selfcheck:
        ap.error("nothing to run: pass --selfcheck")
    if args.device.startswith("cuda") and torch.cuda.device_count() < args.nproc:
        print(f"launch: {args.nproc} ranks need {args.nproc} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    return selfcheck(args.nproc, args.device, args.dataset, args.timeout, tuple(args.b_seeds))


if __name__ == "__main__":
    sys.exit(main())
