"""Diff two value ledgers (port of `scripts/drift_diff.py`): the per-subset
ulp-distance histogram, the max and percentile drift, and the Kendall tau-b
of the induced v(S) ranking.

    python3 -m mplc_tpu_torch.drift_diff A.json B.json [--json] [--gate]

A ledger (`obs/numerics.py`, `MPLC_TORCH_NUMERICS_LEDGER`) holds every
harvested v(S) with its exact float bits and the float path that produced
it (topology, partner shards, ranks, reduction mode, slot bucketing),
keyed by (subset bitmask, engine fingerprint). Diffing two answers whether
two runs (other layouts of ranks, other fleet shard counts, other cards)
computed the same game bit for bit, and if not, how far apart they are and
whether the drift reorders the values. The port's ledgers are the JAX
package's schema, so either package's ledger may be given.

The report, the `--json` document and the exit codes are the JAX
script's: 0 when the ledgers are comparable and equal (or differ without
`--gate`), 1 when `--gate` is set and a common subset's bits differ, 2 on
a usage error, an unreadable ledger, a fingerprint mismatch (other games
are a comparison error, not drift) or no common subset (a gate that
compared nothing must not pass). No torch is imported.
"""

from __future__ import annotations

import argparse
import json
import sys


def format_diff(res: dict, label_a: str, label_b: str) -> str:
    lines = [f"ledger drift: {label_a} vs {label_b}"]
    ma, mb = res.get("meta_a", {}), res.get("meta_b", {})
    lines.append(
        f"  float paths: a=({ma.get('topology')}, part={ma.get('part_shards')}, "
        f"dev={ma.get('n_devices')}, {ma.get('reduction_mode')})  "
        f"b=({mb.get('topology')}, part={mb.get('part_shards')}, "
        f"dev={mb.get('n_devices')}, {mb.get('reduction_mode')})")
    if not res["same_fingerprint"]:
        lines.append("  ! engine fingerprints differ — these ledgers "
                     "describe DIFFERENT GAMES, not drift")
        return "\n".join(lines)
    u = res["ulp"]
    lines.append(
        f"  subsets: common={res['common']}  only_a={res['only_a']}  "
        f"only_b={res['only_b']}")
    lines.append(
        f"  ulp drift: max={u['max']}  p99={u['p99']}  p50={u['p50']}  "
        f"nonzero={u['nonzero']}/{res['common']}")
    if res["histogram"]:
        buckets = sorted(res["histogram"].items(), key=lambda kv: (kv[0] != "0", kv[0]))
        lines.append("  histogram: " + "  ".join(f"{k}:{v}" for k, v in buckets))
    tau = res["kendall_tau"]
    lines.append("  ranking kendall-tau: " + (f"{tau:.4f}" if tau is not None else "n/a"))
    if not res["common"]:
        lines.append("  NOTHING COMPARED — no common subsets")
    elif not res["drift"]:
        lines.append("  ZERO DRIFT — bit-identical values")
    else:
        lines.append("  DRIFT DETECTED")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m mplc_tpu_torch.drift_diff",
        description="Diff two value-provenance ledgers (per-subset ulp drift + ranking tau).")
    ap.add_argument("ledger_a")
    ap.add_argument("ledger_b")
    ap.add_argument("--json", action="store_true", help="emit the raw diff dict as JSON")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when any common subset's value bits differ")
    args = ap.parse_args(argv)

    from .obs import numerics

    try:
        a = numerics.ValueLedger.load(args.ledger_a)
        b = numerics.ValueLedger.load(args.ledger_b)
    except (OSError, ValueError, KeyError) as e:
        print(f"[drift_diff] error: {e}", file=sys.stderr)
        return 2
    res = numerics.diff_ledgers(a, b)
    if args.json:
        print(json.dumps(res, indent=2))
    else:
        print(format_diff(res, args.ledger_a, args.ledger_b))
    if not res["same_fingerprint"]:
        print("[drift_diff] error: fingerprint mismatch — different games cannot be "
              "drift-compared", file=sys.stderr)
        return 2
    if not res["common"]:
        print("[drift_diff] error: ledgers share no common subsets — nothing was compared",
              file=sys.stderr)
        return 2
    if args.gate and res["drift"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
