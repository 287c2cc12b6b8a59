#!/bin/bash
# The dry run's every cell on both production meshes, as `--all
# --both-meshes` covers them, split one process an arch (`--arch A
# --both-meshes`), all at once.  Prints each arch's exit code and wall
# time, then the ok / skipped / error counts.
#   bash scripts/dryrun_all.sh [OUT_DIR] [extra launch.dryrun flags]
# OUT_DIR (default build/dryrun_all) gets one JSON of records an arch,
# a log an arch and all_records.json.
out=${1:-build/dryrun_all}
shift
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
SECONDS=0
for a in gemma2-2b granite-34b qwen1.5-4b qwen1.5-32b jamba-v0.1-52b \
         xlstm-125m seamless-m4t-medium granite-moe-1b-a400m mixtral-8x7b \
         qwen2-vl-72b; do
  rm -f "$out/$a.json"
  (start=$SECONDS
   timeout 840 python3 -m repro_torch.launch.dryrun --arch "$a" \
       --both-meshes --out "$out/$a.json" "$@" > "$out/$a.log" 2>&1
   echo "$a rc=$? in $((SECONDS - start)) s") &
done
wait
echo "all in ${SECONDS} s wall"
python3 - "$out" <<'PY'
import glob, json, os, sys
from collections import Counter
out = sys.argv[1]
recs = [r for f in sorted(glob.glob(os.path.join(out, "*.json")))
        if not f.endswith("all_records.json") for r in json.load(open(f))]
json.dump(recs, open(os.path.join(out, "all_records.json"), "w"), indent=1)
print(len(recs), "records:", dict(Counter(r["status"] for r in recs)))
for r in recs:
    if r["status"] == "ok" and "fits" in r:
        print(r["arch"], r["shape"], r["mesh"], "peak",
              r["peak_bytes_per_device"], "fits", r["fits"],
              "dominant", r.get("dominant"))
    if r["status"] == "error":
        print(r["arch"], r["shape"], r["mesh"], r["error"][:300])
PY
