"""Four cards: the fleet sweep of [fleet] (a)'s MNIST game (the MNIST CNN
at full width, 5 partners, 31 coalitions, 2 epochs, minibatch 10, gup 8,
the deterministic reduce, pinned widths; synthetic MNIST at scale 0.2,
noise 0.75) as W = 1, 2, 4 shards of one card each, 2 shards x 2 cards
and 1 shard x 4 cards, every merged ledger held to the W = 1 run's (zero
ulp, tau-b 1.0, every subset). Prints one line a run and one JSON line.

    python3 build/r22/fleet4.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from mplc_tpu_torch import constants  # noqa: E402
from mplc_tpu_torch.parallel import fleet  # noqa: E402

SPEC = fleet.FleetSpec(dataset="mnist", partners=5, epochs=2, minibatch_count=10,
                       gradient_updates_per_pass=8, deterministic=True, pin_widths=True)
RUNS = [("W=1 x 1 card", 1, 1), ("W=2 x 1 card", 2, 1), ("W=4 x 1 card", 4, 1),
        ("2 shards x 2 cards", 2, 2), ("1 shard x 4 cards", 1, 4)]


def main() -> int:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().replace("\n", " | ")
    except OSError:
        smi = "nvidia-smi not available"
    print(f"[fleet4] {smi}", flush=True)
    os.environ[constants.SYNTH_SCALE_ENV] = "0.2"
    os.environ[constants.SYNTH_NOISE_ENV] = "0.75"
    work = tempfile.mkdtemp(prefix="mplc_fleet4_")
    os.environ[constants.COMPILE_CACHE_DIR_ENV] = os.path.join(work, "bank")
    out, ref, ok = {}, None, True
    for tag, shards, dps in RUNS:
        t0 = time.perf_counter()
        try:
            res = fleet.run_fleet(SPEC, shards, os.path.join(work, f"w{shards}x{dps}"),
                                  devices_per_shard=dps, timeout=900,
                                  verify_against=None if ref is None else ref.ledger)
        except Exception as e:  # noqa: BLE001 - reported, the other runs go on
            ok = False
            print(f"[fleet4] {tag}: FAILED {type(e).__name__}: {str(e)[:1500]}", flush=True)
            continue
        wall = time.perf_counter() - t0
        if ref is None:
            ref = res
        d = res.diff or {}
        same = res.values == ref.values
        ok = ok and same and (res is ref or (not d.get("drift") and d.get("ulp", {}).get("max") == 0
                                             and d.get("kendall_tau") == 1.0
                                             and d.get("common") == len(ref.values)))
        reps = res.shard_reports
        row = {"shards": shards, "devices_per_shard": dps, "wall_s": wall,
               "critical_path_s": max(res.per_shard_sweep_s),
               "sweep_s": res.per_shard_sweep_s,
               "setup_s": [r["setup_s"] for r in reps],
               "coalitions": [len(r["subsets"]) for r in reps],
               "visible": [r["visible_devices"] for r in reps],
               "devices": [r["devices"] for r in reps], "widths": [r["widths"] for r in reps],
               "n_devices": res.ledger["meta"]["n_devices"],
               "bit_equal": same, "max_ulp": d.get("ulp", {}).get("max"),
               "tau_b": d.get("kendall_tau"), "common": d.get("common")}
        out[tag] = row
        print(f"[fleet4] {tag}: critical path {row['critical_path_s']:.3f} s "
              f"(sweep {[round(x, 3) for x in row['sweep_s']]}, set-up "
              f"{[round(x, 2) for x in row['setup_s']]}), wall {wall:.2f} s; slices "
              f"{row['coalitions']} on cards {row['visible']} ({row['devices']} devices a "
              f"shard, ledger n_devices {row['n_devices']}), widths {row['widths']}; against "
              f"W=1: bit-equal {same}, max ulp {row['max_ulp']}, tau-b {row['tau_b']}, "
              f"common {row['common']}; {smi}", flush=True)
    print(json.dumps({"ok": ok, "runs": out, "card": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
