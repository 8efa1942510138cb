#!/bin/bash
# The trained-teacher quality path at its recipes, on the card: the curve
# teacher (600 steps a stage, under the elastic supervisor), the FVD ladders
# (DDIM 8 / 16 / 64 / 250 and DPM++ 4 / 8 / 16 at N 64), both demos, the
# SR witness (300 steps) and the teacher's distillation (4 phases x 400
# steps). The runs write under runs/; their small results (json, jsonl,
# png) and logs are copied into the output directory after every step.
#
#     bash dalle2_video_tpu_torch/probes/quality_path_run.sh [OUT]
out=${1:-runs/quality_path}
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $out/card.txt
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a $out/card.txt
save() {  # copy the small results out after every step
  for d in r2_curve eval_quality demo_inpaint demo_longvideo distill_curve distill_sr; do
    mkdir -p $out/$d
    cp runs/$d/*.json runs/$d/*.jsonl runs/$d/*.png $out/$d/ 2>/dev/null
  done
}
step() {
  local name=$1; shift
  local t0=$(date +%s)
  echo "=== $name: $*"
  "$@" > $out/$name.log 2>&1
  local rc=$?
  echo "=== $name rc=$rc wall $(( $(date +%s) - t0 )) s"
  grep -v "^INFO:dalle2_video_tpu_torch.train_curve\|heartbeat" $out/$name.log | tail -n 12
  save
}
step train_curve python3 -m dalle2_video_tpu_torch.train.elastic --hang-secs 900 --max-restarts 1 -- \
  python3 -m dalle2_video_tpu_torch.train.train_curve 600 run_dir=runs/r2_curve train_name=curve
grep "stage\|resume\|cascade sample" $out/train_curve.log
step eval_ddim python3 -m dalle2_video_tpu_torch.train.eval_quality --ladder 8,16,64,250
step eval_dpmpp python3 -m dalle2_video_tpu_torch.train.eval_quality --ladder 4,8,16 --sampler dpmpp
step demo_inpaint python3 -m dalle2_video_tpu_torch.train.demo_inpaint
step demo_longvideo python3 -m dalle2_video_tpu_torch.train.demo_longvideo
step distill_sr python3 -m dalle2_video_tpu_torch.train.distill_sr_demo
step distill_curve python3 -m dalle2_video_tpu_torch.train.distill --curve runs/r2_curve --run runs/distill_curve
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
