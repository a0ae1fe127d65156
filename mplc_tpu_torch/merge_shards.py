"""Concatenate a sharded grid run's per-host results into one results.csv.

`python3 -m mplc_tpu_torch.main -f cfg.yml --grid-shard I/N` leaves
results_shard0..N-1.csv in the shared experiments/<name>_shardedN/ folder;
this stitches them into the standard results.csv (sorted by the
scenario_id and random_state columns), then renames the shard files to
*.merged so that a results*.csv glob never counts rows twice.

Refuses a partial merge: the folder name encodes the shard count N, and
each host touches .shardI.done as its last act (`mplc_tpu_torch.main`): a
missing marker means that host is still running (or crashed), even if its
csv already has rows. Override with --force only when the missing hosts'
slices are abandoned.

Usage: python3 -m mplc_tpu_torch.merge_shards experiments/<name>_shardedN [-o OUT]
"""

import argparse
import glob
import os
import re
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m mplc_tpu_torch.merge_shards")
    ap.add_argument("folder", help="the shared <name>_shardedN experiment folder")
    ap.add_argument("-o", "--out", default=None,
                    help="output csv (default: <folder>/results.csv)")
    ap.add_argument("--force", action="store_true",
                    help="merge even when shard files are missing")
    ap.add_argument("--keep", action="store_true",
                    help="leave the shard files in place (a results*.csv glob "
                         "then reads every row twice)")
    args = ap.parse_args(argv)

    import pandas as pd

    files = sorted(glob.glob(os.path.join(args.folder, "results_shard*.csv")))
    if not files:
        ap.error(f"no results_shard*.csv in {args.folder!r}")
    # abspath first: a relative spelling like "." must still show the
    # _shardedN suffix, or the completeness check is skipped
    m = re.search(r"_sharded(\d+)$",
                  os.path.normpath(os.path.abspath(args.folder)))
    expected = int(m.group(1)) if m else None
    done = set()
    for f in glob.glob(os.path.join(args.folder, ".shard*.done")):
        dm = re.search(r"\.shard(\d+)\.done$", f)
        if dm:
            done.add(int(dm.group(1)))
    if not args.force:
        if expected is not None:
            required = set(range(expected))
        else:
            # a folder renamed or copied without its _shardedN suffix: N is
            # unknown, but every shard csv present must have its own done
            # marker, or its host may still be appending
            required = {int(re.search(r"results_shard(\d+)\.csv$", f).group(1))
                        for f in files}
        missing = sorted(required - done)
        if missing:
            ap.error(f"{args.folder} has no done markers for shards "
                     f"{missing} — those hosts are still running or crashed "
                     "(csv presence is not completion: rows append as "
                     "scenarios finish). --force to merge anyway")
    df = pd.concat([pd.read_csv(f) for f in files], ignore_index=True)
    sort_cols = [c for c in ("scenario_id", "random_state") if c in df.columns]
    if sort_cols:
        df = df.sort_values(sort_cols, kind="stable")
    out = args.out or os.path.join(args.folder, "results.csv")
    df.to_csv(out, index=False)
    if not args.keep:
        for f in files:
            os.replace(f, f + ".merged")
        # retire the markers with the csvs: a later run into this folder
        # must not inherit them
        for i in sorted(done):
            marker = os.path.join(args.folder, f".shard{i}.done")
            if os.path.exists(marker):
                os.remove(marker)
    print(f"merged {len(files)} shard files, {len(df)} rows -> {out}"
          + ("" if args.keep else " (shard files renamed to *.merged)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
