#!/bin/bash
# The lift's other arms and replicas through the port on one card
# (python -m mmt_psm_tpu_torch.tools.mt_lift_experiment, --sharpen --hard-neg),
# as concurrent processes, each host-bound, on one card that is mostly idle:
# seed 0's odkd, psm and mgd arms, a second run of its sup arm, seeds 1 and 3
# (sup and mt), then the pseudo-label probe after 400 supervised iterations.
# Final saves only (--ckpt-period 0). JSONs and logs in $1 (default
# runs/lift); the arms' seconds are those of processes sharing the card.
#
#     bash scripts/lift_runs_torch.sh [OUT_DIR]
out=${1:-runs/lift}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
run() {  # name, args...
  local name=$1; shift
  OMP_NUM_THREADS=2 python3 -m mmt_psm_tpu_torch.tools.mt_lift_experiment --sharpen --hard-neg --ckpt-period 0 \
    --out "$out/$name.json" "$@" > "$out/$name.log" 2>&1
  echo "$name rc=$?" >> "$out/rc.txt"
}
run odkd_s0 --arms odkd --tag odkd &
run psm_s0 --arms psm --tag psm &
run mgd_s0 --arms mgd --tag mgd &
run sup_s0_repeat --arms sup --tag repeat &
run seed1 --seed 1 &
run seed3 --seed 3 &
wait
OMP_NUM_THREADS=2 python3 -m mmt_psm_tpu_torch.tools.pseudo_label_probe --iters 400 --out "$out/probe_s0.json" \
  > "$out/probe_s0.log" 2>&1
echo "probe rc=$?" >> "$out/rc.txt"
cat "$out/rc.txt"
grep -h "trained" "$out"/*.log
