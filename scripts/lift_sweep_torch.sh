#!/bin/bash
# The lift's seed sweep and its float32 diagnostic through the port on one
# card (python -m mmt_psm_tpu_torch.tools.mt_lift_experiment, --sharpen
# --hard-neg, 1800 iterations, MT from 400, 256 px), as concurrent
# processes, each host-bound, on one card that is mostly idle:
#   - the sup and mt arms at seeds 2 and 4 (with seeds 0, 1 and 3 of
#     scripts/lift_runs_torch.sh, five seeds);
#   - the mgd and psm arms at seeds 1 and 3;
#   - the sup, mt and mgd arms at seed 0 with the whole model in float32
#     (scripts/lift_f32_torch.py, TF32 off);
#   - the sup arm at seed 0 again, in bf16, beside the earlier run of it.
# One process an arm, final saves only (--ckpt-period 0), each arm's saves
# in a directory of its own under $TMPDIR (default /tmp), removed when the
# arm ends. The arms of a seed are merged into one JSON as the tool writes
# it for both arms. JSONs, logs and the card's name and power limit in $1
# (default runs/lift_sweep); the arms' seconds are those of processes
# sharing the card and its host.
#
#     bash scripts/lift_sweep_torch.sh [OUT_DIR]
out=${1:-runs/lift_sweep}
tmp=${TMPDIR:-/tmp}/lift_sweep
mkdir -p "$out" "$tmp"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
run() {  # name, entry point (module or script), args...
  local name=$1 entry=$2; shift 2
  mkdir -p "$tmp/$name"
  if [[ $entry == *.py ]]; then set -- "$entry" "$@"; else set -- -m "$entry" "$@"; fi
  TMPDIR="$tmp/$name" OMP_NUM_THREADS=1 python3 "$@" --sharpen --hard-neg --ckpt-period 0 \
    --out "$out/$name.json" > "$out/$name.log" 2>&1
  echo "$name rc=$?" >> "$out/rc.txt"
  rm -rf "${tmp:?}/$name"
}
tool=mmt_psm_tpu_torch.tools.mt_lift_experiment
f32=scripts/lift_f32_torch.py
for seed in 2 4; do
  run "sup_s$seed" $tool --seed $seed --arms sup &
  run "mt_s$seed" $tool --seed $seed --arms mt &
done
for seed in 1 3; do
  run "mgd_s$seed" $tool --seed $seed --arms mgd --tag mgd &
  run "psm_s$seed" $tool --seed $seed --arms psm --tag psm &
done
for arm in sup mt mgd; do
  run "f32_${arm}_s0" $f32 --arms $arm --tag f32 &
done
run sup_s0_again $tool --arms sup --tag again &
wait
# the two arms of a seed (or of the f32 runs) in one JSON: the arms' keys,
# each arm's own meta under meta.arms
python3 - "$out" <<'EOF'
import json, os, sys
out = sys.argv[1]
groups = {"seed2": ["sup_s2", "mt_s2"], "seed4": ["sup_s4", "mt_s4"], "f32_seed0": ["f32_sup_s0", "f32_mt_s0", "f32_mgd_s0"]}
for group, names in groups.items():
    merged, metas = {}, {}
    for n in names:
        path = os.path.join(out, n + ".json")
        if not os.path.exists(path):
            continue
        d = json.load(open(path))
        metas[n] = d.pop("meta")
        merged.update(d)
    if metas:
        merged["meta"] = {**next(iter(metas.values())), "arms": metas}
        json.dump(merged, open(os.path.join(out, group + ".json"), "w"), indent=2)
EOF
cat "$out/rc.txt"
grep -h "trained" "$out"/*.log
