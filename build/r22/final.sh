set -x
OUT="$(realpath -m "${1:?usage: bash final.sh OUTPUT_FOLDER}")"
mkdir -p "$OUT"
cd build/archive
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 chip_smoke.py > "$OUT"/smoke.log 2>&1; echo "smoke rc=$?"
tail -12 "$OUT"/smoke.log | cut -c1-2500
python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider > "$OUT"/cuda.log 2>&1; echo "cuda rc=$?"
tail -5 "$OUT"/cuda.log
