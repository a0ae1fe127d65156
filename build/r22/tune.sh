set -x
OUT="${1:?usage: bash tune.sh OUTPUT_FOLDER}"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
# [fleet] (e)'s command alone: both shards wrapped onto the one card
python3 -m mplc_tpu_torch.parallel.fleet --selfcheck --shards 2 --devices-per-shard 1 > "$OUT"/fleet_cards.log 2>&1; echo "fleet cards rc=$?"
grep -a "^\[fleet worker\]\|^{" "$OUT"/fleet_cards.log | cut -c1-700
python3 -m mplc_tpu_torch.tune_coalition_cap > "$OUT"/tune_default.log 2>&1; echo "tune default rc=$?"
tail -6 "$OUT"/tune_default.log
python3 -m mplc_tpu_torch.tune_coalition_cap --minibatch-count 2 --gradient-updates 3 > "$OUT"/tune_mb2_gup3.log 2>&1; echo "tune mb2 gup3 rc=$?"
tail -8 "$OUT"/tune_mb2_gup3.log
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
