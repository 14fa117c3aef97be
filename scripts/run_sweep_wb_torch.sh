#!/usr/bin/env bash
# Multi-seed Waterbirds sweep grid through the PyTorch port (the twin of
# run_sweep_wb.sh): bs in {512,1024} x bsr in {64,128,256,512} x lr in
# {1,10}, 3 seeds each, trained as stacked simultaneous rows per cell.
# Runs on the card unless REPRO_DEVICE=cpu.
set -euo pipefail
cd "$(dirname "$0")/.."

dataset="waterbirds"
DATA_ROOT="${REPRO_DATA_ROOT:-data}"
data_dir="${DATA_ROOT}/waterbirds/waterbird_complete95_forest2water2"
emb_dir="${DATA_ROOT}/embeddings_unnormalized/${dataset}"

python -m debiasing_multi_modal_tpu_torch.cli.sweep_main \
  --epochs 100 --epochs_feature_learning 40 \
  --dataset ${dataset} \
  --text_embedding_dir "${emb_dir}/clip_class.json" \
  --text_spurious_embedding_dir "${emb_dir}/clip_spurious.json" \
  --text_group_embedding_dir "${emb_dir}/clip_group.json" \
  --image_embedding_dir "${emb_dir}/RN50/clip.npz" \
  --data_dir "${data_dir}" \
  --tl_method adapter_reg_seq_alter --train_target class \
  --warm_reg --lr_decay_rate 0.1 --lr_decay_epochs 90,95 --add_adapter \
  --num_iter 3 --random_seeds 42,32,22 \
  --lr_list 1,10 --bs_list 512,1024 --bsr_list 64,128,256,512 \
  --lr_multiple 1.0 --device "${REPRO_DEVICE:-cuda}" "$@"
