set -x
OUT="${1:?usage: bash four.sh OUTPUT_FOLDER}"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m mplc_tpu_torch.parallel.launch --nproc 4 --selfcheck > "$OUT"/selfcheck4.log 2>&1; echo "selfcheck rc=$?"
grep -a "^\[selfcheck\]" "$OUT"/selfcheck4.log | cut -c1-900
python3 build/r22/fleet4.py > "$OUT"/fleet4.log 2>&1; echo "fleet4 rc=$?"
python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider -k "four_cards_run_a_fleet" > "$OUT"/cuda4.log 2>&1; echo "cuda rc=$?"
tail -5 "$OUT"/cuda4.log
grep -a "^\[fleet4\]" "$OUT"/fleet4.log | cut -c1-1500
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
